"""The roofline arithmetic against hand-worked shapes, and the trace
reader (idle share, launches, attribution to ranges, breakdown) on a small
recorded trace."""

import json

import pytest
import torch

from bench_h100 import instrument
from bench_h100.harness import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from bench_h100.trace import Trace, union_seconds


def test_attention_cost_by_hand():
    # SD-1.5's largest self-attention at batch 2: T 4096, 8 heads of 40
    q = k = v = out = torch.empty(2, 4096, 8, 40, dtype=torch.bfloat16, device="meta")
    flops, nbytes = instrument.attention_cost(q, k, v, out)
    assert flops == 4 * 2 * 8 * 4096 * 4096 * 40          # QK^T and PV, 2 FLOPs a MAC
    assert nbytes == 4 * 2 * 4096 * 320 * 2
    least = instrument.least_seconds(flops, nbytes)
    assert least == pytest.approx(flops / PEAK_BF16_FLOPS)   # compute-bound
    # cross-attention: 77 keys
    k = v = torch.empty(2, 77, 8, 40, dtype=torch.bfloat16, device="meta")
    flops, nbytes = instrument.attention_cost(q, k, v, out)
    assert flops == 4 * 2 * 8 * 4096 * 77 * 40
    assert nbytes == (2 * 2 * 4096 * 320 + 2 * 2 * 77 * 320) * 2


def test_groupnorm_cost_by_hand():
    x = out = torch.empty(2, 320, 64, 64, dtype=torch.bfloat16, device="meta")
    w = b = torch.empty(320, dtype=torch.bfloat16, device="meta")
    flops, nbytes = instrument.groupnorm_cost(x, w, b, out)
    assert nbytes == 2 * (2 * 320 * 64 * 64) * 2 + 2 * 320 * 2
    assert instrument.least_seconds(flops, nbytes) == pytest.approx(nbytes / PEAK_BYTES_PER_S)


def test_union_of_intervals():
    assert union_seconds([(0, 2), (1, 3), (5, 6), (6, 7)]) == 5
    assert union_seconds([]) == 0


def _trace():
    """A recorded window of 100 us: one range `bench.attn.0` on thread 1
    launching two kernels, a copy, a kernel outside the range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.attn.0", "pid": 1, "tid": 1,
         "ts": 10, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 12, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 13, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 20, "dur": 2, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 1, "tid": 1,
         "ts": 50, "dur": 2, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": 1, "tid": 2,
         "ts": 60, "dur": 2, "args": {"correlation": 10}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7, "ts": 20, "dur": 10,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "softmax", "pid": 0, "tid": 7, "ts": 25, "dur": 10,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7, "ts": 55,
         "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7, "ts": 70, "dur": 10,
         "args": {"correlation": 10}},
    ]
    return Trace(ev, wall_s=100e-6)


def test_idle_share_launches_and_ranges(tmp_path):
    t = _trace()
    assert t.busy_s() == pytest.approx(30e-6)             # [20, 35) + [55, 60) + [70, 80)
    assert t.idle_share() == pytest.approx(0.7)
    assert t.launches() == 3                              # the copy is no launch
    assert t.range_device_s("bench.attn.") == {"bench.attn.0": pytest.approx(20e-6)}
    calls = {"bench.attn.0": 10e-6}
    assert instrument.roofline_share(calls, t.range_device_s("bench.attn.")) == pytest.approx(50)
    assert instrument.roofline_share(calls, {}) is None
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in (t.device + t.host_calls
                                                             + t.cpu_ops)]}))
    assert Trace.load(str(path), 100e-6).busy_s() == pytest.approx(30e-6)


def test_breakdown_names_ops_and_gaps():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    gaps = dict(b["idle_gaps"])
    # the gap before the copy (35 -> 55) was spent launching it inside no op;
    # the one before the last gemm (60 -> 70) in the launch on thread 2
    assert gaps["cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert gaps["cuLaunchKernel"] == pytest.approx(10e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
