"""Each driver run end to end on the CPU at a tiny size (the harness's look
for a card skipped, the program on its plain paths), against the plain
reference; and the same runs with the timed path broken underneath, which
the check has to call not correct."""

import contextlib
import io
import json

import pytest

from bench_h100 import run as entry
from bench_h100.tests import tiny

SEED = 2 ** 31 + 101


def drive(name: str, seconds: float = 2.0, trace: int = 0, **params) -> dict:
    cell = tiny.cell(name, **dict(tiny.SERVE if "serve" in name else tiny.TRAIN, **params))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry.main(["--workload", name, "--seed", str(SEED), "--seconds", str(seconds),
                         "--trace", str(trace)], device="cpu", cfg=tiny.config(), cell=cell)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_serve_dry_run(trace):
    res = drive("sd15-serve-poisson", trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 4
    assert list(res["checks"]) == ["failed_requests", "image_off4"]
    key = "serve.mean_batch_size.lat" if trace else "latency_p90_s"
    assert key in res["metrics"] and "setup_s" in res["metrics"] or trace


@pytest.mark.parametrize("trace", [0, 1])
def test_train_dry_run(trace):
    res = drive("sd15-train-bs4", trace=trace)
    assert res["correct"] and res["attempted"] >= 1
    assert list(res["checks"]) == ["grad_leaf_gap", "change_median_gap"]
    key = "mfu.train" if trace else "train_samples_per_s"
    assert key in res["metrics"]
    assert 0.0 < res["metrics"][key]["value"]


def test_serve_an_altered_answer_is_not_correct(monkeypatch):
    """The served image altered where the pipeline produces it."""
    from reflecting_reality_tpu_torch.pipelines import brushnet_pipeline as bp

    real = bp.to_uint8
    monkeypatch.setattr(bp, "to_uint8", lambda img: real(img.flip(-1)))
    res = drive("sd15-serve-poisson")
    assert not res["correct"]
    assert res["checks"]["image_off4"]["value"] > res["checks"]["image_off4"]["limit"]


def test_train_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    """The optimizer's update dropped: every step returns its state unchanged."""
    from reflecting_reality_tpu_torch.training import train_step as ts

    monkeypatch.setattr(ts, "apply_update", lambda *a, **k: None)
    res = drive("sd15-train-bs4")
    assert not res["correct"]
    assert res["checks"]["change_median_gap"]["value"] == pytest.approx(1.0, abs=0.01)


def test_train_half_the_batch_left_out_is_not_correct(monkeypatch):
    """The loss taken as the mean over the first half of the batch."""
    from reflecting_reality_tpu_torch.training import train_step as ts

    real = ts.diffusion_loss

    def half(pred, target, *a, **k):
        n = pred.shape[0] // 2
        return real(pred[:n], target[:n], *a, **k)

    monkeypatch.setattr(ts, "diffusion_loss", half)
    res = drive("sd15-train-bs4")
    assert not res["correct"]
    assert res["checks"]["grad_leaf_gap"]["value"] > res["checks"]["grad_leaf_gap"]["limit"]


@pytest.mark.parametrize("trace", [0, 1])
def test_closed_loop_dry_run(trace):
    cell = tiny.cell("sdxl-closed", **tiny.CLOSED)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry.main(["--workload", "sdxl-closed", "--seed", str(SEED), "--seconds", "1",
                         "--trace", str(trace)], device="cpu", cfg=tiny.config_xl(), cell=cell)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1
    assert ("mfu.img" if trace else "images_per_s") in res["metrics"]


def test_closed_loop_an_altered_answer_is_not_correct(monkeypatch):
    from reflecting_reality_tpu_torch.pipelines import brushnet_pipeline as bp

    real = bp.to_uint8
    monkeypatch.setattr(bp, "to_uint8", lambda img: real(img.flip(-1)))
    cell = tiny.cell("sdxl-closed", **tiny.CLOSED)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        entry.main(["--workload", "sdxl-closed", "--seed", str(SEED), "--seconds", "1"],
                   device="cpu", cfg=tiny.config_xl(), cell=cell)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert not res["correct"]


def _ddp(monkeypatch, **params):
    """The data-parallel cell (not in BENCHMARK.json yet: unproved on four
    cards) on two gloo ranks on the CPU, with its entries added."""
    from bench_h100 import harness

    cell = tiny.cell("sd15-train-ddp4", **dict(tiny.TRAIN, samples=32, **params))
    cell["chips"] = 2
    bench = harness.benchmark_json()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_samples_per_s", "mfu.train", "device.idle_share.train"):
            m["workloads"].append("sd15-train-ddp4")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry.main(["--workload", "sd15-train-ddp4", "--seed", str(SEED), "--seconds", "2"],
                        device="cpu", cfg=tiny.config(), cell=cell, bench=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_ddp_dry_run(monkeypatch):
    res = _ddp(monkeypatch)
    assert res["correct"] and "train_samples_per_s" in res["metrics"]


def test_ddp_the_exchange_between_ranks_left_out_is_not_correct(monkeypatch, tmp_path):
    """Each rank keeps its own gradient (no all-reduce): the ranks' updates
    then follow their own quarter of the batch, which the check sees.  The
    fault is planted in the ranks' processes through a sitecustomize."""
    (tmp_path / "sitecustomize.py").write_text(
        "from reflecting_reality_tpu_torch.parallel import multihost\n"
        "multihost.all_reduce_mean = lambda tensors: None\n")
    import os

    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    res = _ddp(monkeypatch)
    assert not res["correct"]
