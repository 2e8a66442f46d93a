"""The FLUX.1 Fill closed loop and the saturated serving cell run end to
end on the CPU at tiny sizes (the harness's look for a card skipped, the
program on its plain paths) against the plain reference; and the same runs
with the timed path broken underneath, which the check has to call not
correct."""

import contextlib
import io
import json

import pytest

from bench_h100 import run as entry
from bench_h100.tests import tiny, tiny_flux

SEED = 2 ** 31 + 303


def drive_flux(trace: int = 0, seconds: float = 1.0, control=None) -> tuple:
    cell = tiny_flux.cell("flux-fill-closed", **tiny_flux.FLUX)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry.main(["--workload", "flux-fill-closed", "--seed", str(SEED), "--seconds",
                         str(seconds), "--trace", str(trace)], device="cpu",
                        cfg=tiny_flux.config(), cell=cell, control=control)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def drive_saturated(trace: int = 0, seconds: float = 2.0) -> dict:
    cell = tiny_flux.cell("sd15-serve-saturated", **tiny_flux.SATURATED)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry.main(["--workload", "sd15-serve-saturated", "--seed", str(SEED), "--seconds",
                         str(seconds), "--trace", str(trace)], device="cpu",
                        cfg=tiny.config(), cell=cell)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_flux_closed_loop_dry_run(trace):
    res, err = drive_flux(trace)
    assert res["correct"] and res["attempted"] >= 1, err[-2000:]
    assert list(res["checks"]) == ["pred_gap", "replay_off4"]
    if trace:
        assert "mfu.flux.img" in res["metrics"]        # the device readers need a card
        assert 0.0 < res["metrics"]["mfu.flux.img"]["value"]
    else:
        assert {"images_per_s", "setup_s"} <= set(res["metrics"])
    # every joint attention counted, the plain route on the CPU: 3 a step
    assert "joint attentions a step: {'flash': 0.0, 'plain': 3.0}" in err


def test_flux_control_reads_the_float8_reference():
    """The float8 reference in the program's place fails the cell's own
    check, its velocities far beyond the program's gap."""
    program, _ = drive_flux()
    res, err = drive_flux(control="fp8")
    readings = [json.loads(t[t.index("{"):t.index("}") + 1])
                for t in err.splitlines() if t.startswith("reading ")]
    assert readings and "the float8 reference in the program's place" in err
    assert not res["correct"]
    gap = res["checks"]["pred_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] > 10 * program["checks"]["pred_gap"]["value"]


def test_flux_the_rotary_embedding_left_out_is_not_correct(monkeypatch):
    """The joint attentions' q and k left unrotated."""
    from reflecting_reality_tpu_torch.models import flux_transformer as ft

    monkeypatch.setattr(ft, "apply_rope", lambda x, cos, sin: x)
    res, _ = drive_flux()
    assert not res["correct"]
    assert res["checks"]["pred_gap"]["value"] > res["checks"]["pred_gap"]["limit"]


def test_flux_a_scaled_single_stream_block_is_not_correct(monkeypatch):
    """Each single-stream block's update made half as large again."""
    from reflecting_reality_tpu_torch.models import flux_transformer as ft

    real = ft.FluxSingleTransformerBlock.forward

    def moved(self, x, temb, rope):
        return x + 1.5 * (real(self, x, temb, rope) - x)

    monkeypatch.setattr(ft.FluxSingleTransformerBlock, "forward", moved)
    res, _ = drive_flux()
    assert not res["correct"]


@pytest.mark.parametrize("trace", [0, 1])
def test_saturated_serving_dry_run(trace):
    res = drive_saturated(trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    assert list(res["checks"]) == ["failed_requests", "image_off4"]
    if not trace:
        assert res["metrics"]["images_per_s"]["value"] > 0


def test_saturated_serving_an_altered_answer_is_not_correct(monkeypatch):
    from reflecting_reality_tpu_torch.pipelines import brushnet_pipeline as bp

    real = bp.to_uint8
    monkeypatch.setattr(bp, "to_uint8", lambda img: real(img.flip(-1)))
    res = drive_saturated()
    assert not res["correct"]
    assert res["checks"]["image_off4"]["value"] > res["checks"]["image_off4"]["limit"]


def test_saturated_window_closes_at_the_first_reply_after_its_seconds():
    """The window opens at the first batch's last reply and closes at the
    last reply of the first batch whose last reply is 10 s or more later,
    counting every reply of the batches between, the closing one whole."""
    from bench_h100.drivers.serve_closed_loop import window_of

    reqs = [{"seed": 100 + i, "prompt": f"p{i}"} for i in range(9)]
    done = [1.0, 1.1, 4.0, 4.2, 7.5, 11.0, 11.3, 11.4, 14.0]
    status = [200] * 9
    status[4] = 503
    results = [{"id": i, "done": d, "status": s} for i, (d, s) in enumerate(zip(done, status))]
    keys = [(r["seed"], r["prompt"]) for r in reqs]
    batches = [{"keys": keys[a:b]} for a, b in ((0, 2), (2, 4), (4, 5), (5, 8), (8, 9))]
    # opens at 1.1; the batch of 4.0-4.2 and the failed one add 2 images; the
    # batch whose last reply is 11.4 >= 11.1 closes it with its 3
    assert window_of(results, batches, reqs, 10.0) == (1.1, 11.4, 5, 1)
    # no batch 20 s on: it closes at the last batch
    assert window_of(results, batches, reqs, 20.0) == (1.1, 14.0, 6, 1)
    with pytest.raises(RuntimeError):
        window_of(results[:2], batches[:1], reqs, 10.0)
