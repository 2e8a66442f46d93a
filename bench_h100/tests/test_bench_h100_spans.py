"""The span readers (`bench_h100/spans.py`) on a synthetic Chrome trace with
`rr.*` ranges and the records that pair with them: the clock offset, idle
time within the calls, `idle_by_span`'s labels (a span the trace lacks, a
launch from a thread with no span, `(unspanned)`, `(between calls)`), each
span metric with the serving readers' cut at the profiler's start, the two
benchmark metrics that read the spans' ranges alone; and the tool end to
end on the CPU for each one-card traffic kind."""

import contextlib
import io
import json
import types

import pytest

from bench_h100 import harness, spans
from bench_h100.tests import tiny
from bench_h100.trace import Trace

OFFSET = 1000.0        # trace us = record us + OFFSET
A, B, C = 11, 12, 13   # the trace's thread ids; A's records carry native id 501


def rec(name, sid, t0_us, t1_us, parent=None, tid=501, **attrs):
    return {"name": name, "id": sid, "parent": parent, "tid": tid, "t0_ns": int(t0_us * 1e3),
            "t1_ns": int(t1_us * 1e3), "attrs": attrs}


def _records():
    return [
        rec("rr.pipeline.call", 1, 0, 100),            # opened before the profiler: not traced
        rec("rr.pipeline.step", 2, 5, 60, parent=1),   # the same
        rec("rr.unet", 3, 20, 50, parent=2),
        rec("rr.pipeline.decode", 4, 70, 90, parent=1),
        rec("rr.serve.queue_wait", 5, 0, 95),          # memory only: never a launch's span
        rec("rr.pipeline.text", 9, 1, 2),
    ]


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _trace():
    """The profiler's window is [1010, 1215) us; the ranges of spans 3, 4
    and 9 (4 read 2 us late, which the median offset passes over)."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "rr.unet#3", "pid": 1, "tid": A,
         "ts": 1020, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "rr.pipeline.decode#4", "pid": 1, "tid": A,
         "ts": 1072, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "rr.pipeline.text#9", "pid": 1, "tid": A,
         "ts": 1001, "dur": 1},
        _launch(A, 1011, 1), _kernel(1012, 8, 1),       # first operation: no gap before it
        _launch(A, 1030, 2), _kernel(1035, 5, 2),       # gap 15, launched in rr.unet
        _launch(B, 1065, 3), _kernel(1066, 2, 3),       # gap 26, autograd-like thread B
        _launch(A, 1080, 4), _kernel(1085, 5, 4),       # gap 17, in rr.pipeline.decode
        _launch(C, 1105, 5), _kernel(1110, 5, 5),       # gap 20, after the call, overlapping it
        _launch(C, 1200, 6), _kernel(1210, 5, 6),       # gap 95, between calls
    ]
    return Trace(ev, wall_s=205e-6)


def test_clock_offset_is_the_median_over_pairs():
    assert spans.clock_offset_us(_trace(), _records()) == pytest.approx(OFFSET)
    assert spans.clock_offset_us(_trace(), _records()[:2]) is None


def test_idle_within_the_calls():
    trace = _trace()
    ivs = spans.intervals(_records(), ("rr.pipeline.call",), OFFSET)
    assert ivs == [(1000.0, 1100.0)]
    idle, length = spans.idle_within(trace, ivs, (1010.0, 1215.0))
    # the call cut to [1010, 1100): busy 8 + 5 + 2 + 5
    assert length == pytest.approx(90e-6) and idle == pytest.approx(70e-6)
    idle, length = spans.idle_within(trace, ivs + [(1050.0, 1105.0)], (1010.0, 1215.0))
    assert length == pytest.approx(95e-6) and idle == pytest.approx(75e-6)
    assert spans.idle_within(trace, [], (1010.0, 1215.0)) == (0.0, 0.0)


def test_idle_by_span_labels():
    out = dict(spans.idle_by_span(_trace(), _records(), OFFSET))
    assert out == pytest.approx({spans.BETWEEN: 95e-6, "rr.pipeline.call": 26e-6,
                                 spans.UNSPANNED: 20e-6, "rr.pipeline.decode": 17e-6,
                                 "rr.unet": 15e-6})
    # the gaps are idle_gaps' own: the same total
    assert sum(out.values()) == pytest.approx(sum(s for _, s in _trace().breakdown()["idle_gaps"]))


def _serve_records():
    s = 1e6                                             # us a second
    return [
        rec("rr.serve.batch", 10, 0.1 * s, 0.2 * s, batch=0),     # warm-up, before the window
        rec("rr.serve.batch", 11, 1.0 * s, 3.9 * s, batch=1),
        rec("rr.serve.batch", 12, 4.0 * s, 7.1 * s, batch=2),
        rec("rr.serve.batch", 13, 16.0 * s, 25.0 * s, batch=3),   # after the profiler opened
        rec("rr.serve.queue_wait", 20, 0.5 * s, 1.0 * s, batch=1, request=0),
        rec("rr.serve.queue_wait", 21, 3.8 * s, 4.0 * s, batch=2, request=1),
        rec("rr.serve.queue_wait", 22, 3.0 * s, 4.0 * s, batch=2, request=2),
        rec("rr.serve.queue_wait", 23, 12.0 * s, 16.0 * s, batch=3, request=3),
        rec("rr.serve.queue_wait", 24, 0.0, 0.1 * s, batch=0, request=None),
        rec("rr.serve.request", 30, 0.5 * s, 4.0 * s, request=0, batch=1),
        rec("rr.serve.encode", 31, 3.95 * s, 4.0 * s, parent=30, request=0),
        rec("rr.serve.request", 32, 3.8 * s, 7.3 * s, request=1, batch=2),
        rec("rr.serve.encode", 33, 7.2 * s, 7.3 * s, parent=32, request=1),
        rec("rr.serve.request", 34, 3.0 * s, 7.2 * s, request=2, batch=2),
        rec("rr.serve.encode", 35, 7.18 * s, 7.2 * s, parent=34, request=2),
        rec("rr.serve.request", 36, 12.0 * s, 25.1 * s, request=3, batch=3),
        rec("rr.serve.encode", 37, 25.0 * s, 25.1 * s, parent=36, request=3),
    ]


def test_serving_readers_keep_the_batches_before_the_profiler(capsys):
    profiler = types.SimpleNamespace(t0=15.0, t1=19.0)
    ctx = spans.Spans(_serve_records(), None, profiler, window_t0_s=0.5)
    assert spans.queue_wait_p50_s(ctx) == pytest.approx(0.5)       # of 0.5, 0.2, 1.0
    assert "3 requests in 2 batches" in capsys.readouterr().err
    assert spans.service_p50_s(ctx) == pytest.approx(3.0)          # of 2.9 and 3.1
    assert spans.request_p50_s(ctx) == pytest.approx(3.5)          # of 3.5, 3.5, 4.2
    assert spans.encode_p50_ms(ctx) == pytest.approx(50.0)         # of 50, 100, 20
    late = spans.Spans(_serve_records(), None, profiler, window_t0_s=20.0)
    for read in (spans.queue_wait_p50_s, spans.service_p50_s, spans.request_p50_s,
                 spans.encode_p50_ms):
        assert read(late) is None


def test_loader_wait_share_within_the_window():
    waits = [rec("rr.loader.wait", 1, 0.5e6, 1.5e6),     # half before the window
             rec("rr.loader.wait", 2, 2e6, 2.2e6),
             rec("rr.loader.wait", 3, 10.9e6, 11.5e6),   # a tenth of a second inside
             rec("rr.train.step", 4, 2.2e6, 2.6e6)]
    ctx = spans.Spans(waits, None, None, window_t0_s=1.0, window_s=10.0)
    assert spans.loader_wait_share(ctx) == pytest.approx(100.0 * (0.5 + 0.2 + 0.1) / 10.0)
    assert spans.loader_wait_share(spans.Spans(waits[3:], None, None, 1.0, 10.0)) is None
    assert spans.loader_wait_share(spans.Spans(waits, None, None, 1.0)) is None


def test_idle_in_call_share_and_ms_per_range():
    profiler = types.SimpleNamespace(t0=10e-6, t1=215e-6)            # [1010, 1215) on the trace
    ctx = spans.Spans(_records(), _trace(), profiler, window_t0_s=0.0)
    assert ctx.window_us == pytest.approx((1010.0, 1215.0))
    assert spans.idle_in_call_share(ctx) == pytest.approx(100.0 * 70 / 90)
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "rr.brushnet#7", "pid": 1, "tid": A,
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "rr.brushnet#8", "pid": 1, "tid": A,
         "ts": 20, "dur": 10},
        _launch(A, 2, 1), _kernel(3, 4, 1), _launch(A, 22, 2), _kernel(23, 6, 2),
        _launch(A, 40, 3), _kernel(41, 50, 3),                         # outside both ranges
    ]
    ctx = spans.Spans([], Trace(ev, wall_s=1e-4), None, window_t0_s=0.0)
    assert spans.idle_in_call_share(ctx) is None                    # no profiler window
    # the benchmark's range-only readers: a program without the spans reads None
    brushnet = harness.metric_reader("pipeline.brushnet_ms.img")
    optimizer = harness.metric_reader("train.optimizer_ms.train")
    run = types.SimpleNamespace(trace_obj=Trace(ev, wall_s=1e-4), data={})
    assert brushnet(run) == pytest.approx(5e-3)
    assert optimizer(run) is None
    assert brushnet(types.SimpleNamespace(trace_obj=_trace(), data={})) is None
    assert brushnet(types.SimpleNamespace(trace_obj=None, data={})) is None
    for e in ev[:2]:
        e["name"] = e["name"].replace("rr.brushnet", "rr.train.optimizer")
    assert optimizer(types.SimpleNamespace(trace_obj=Trace(ev, wall_s=1e-4))) == pytest.approx(5e-3)


@pytest.mark.parametrize("name,cfg,params", [
    ("sd15-serve-poisson", tiny.config, tiny.SERVE),
    ("sd15-train-bs4", tiny.config, tiny.TRAIN),
    ("sdxl-closed", tiny.config_xl, tiny.CLOSED),
])
def test_the_tool_runs_each_one_card_kind(name, cfg, params, capsys):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = spans.main(["--workload", name, "--seed", str(2 ** 31 + 7), "--seconds", "2",
                         "--trace", "1"], device="cpu", cfg=cfg(), cell=tiny.cell(name, **params))
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"]
    assert "idle_by_span" in res["breakdown"]         # empty: a CPU trace has no device time
    assert int(capsys.readouterr().err.split("spans recorded: ")[1].split()[0]) > 0
    if name.startswith("sd15-serve"):
        for metric in ("serve.service_p50_s.lat", "serve.request_p50_s.lat",
                       "serve.encode_p50_ms.lat"):
            assert metric in res["metrics"]
    if name.startswith("sd15-train"):
        assert "loader.wait_span_share.train" in res["metrics"]


def test_the_tool_refuses_the_four_card_cell():
    assert spans.main(["--workload", "sd15-train-ddp4", "--seed", "1", "--seconds", "1"],
                      device="cpu") == 2
