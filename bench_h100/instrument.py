"""Ranges the benchmark opens around the program's calls into a layer, for
the per-layer metrics that read the device trace, and the least time of
each call from its shapes (the roofline).

`Ranges` wraps a module-level function of the program (looked up there at
each call, so the wrapper is what the program calls) and, while `enabled()`
holds, opens a `record_function` range `bench.<what>.<i>` around call i and
notes its least time: the larger of its FLOPs over the bf16 peak and its
bytes (each input and output byte once) over the HBM bandwidth.
"""

from __future__ import annotations

import importlib

from bench_h100.harness import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def attention_cost(q, k, v, out):
    """(FLOPs, bytes) of softmax(Q K^T) V over (B, T, H, D) tensors."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    flops = 4.0 * b * h * tq * tk * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return flops, nbytes


def groupnorm_cost(x, weight, bias, out):
    """(FLOPs, bytes) of a GroupNorm (+SiLU): bytes-bound, about ten
    operations an element."""
    flops = 10.0 * x.numel()
    nbytes = sum(t.numel() * t.element_size() for t in (x, weight, bias, out))
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


class Ranges:
    def __init__(self, module: str, fn: str, what: str, cost, enabled):
        self.mod = importlib.import_module(module)
        self.fn, self.what, self.cost, self.enabled = fn, what, cost, enabled
        self.orig = getattr(self.mod, fn)
        self.calls = {}               # range name -> least seconds
        orig = self.orig

        def wrapper(*args, **kwargs):
            if not self.enabled():
                return orig(*args, **kwargs)
            import torch

            name = f"bench.{self.what}.{len(self.calls)}"
            with torch.profiler.record_function(name):
                out = orig(*args, **kwargs)
            self.calls[name] = least_seconds(*self.cost(*args[:3], out))
            return out

        setattr(self.mod, fn, wrapper)

    def remove(self) -> None:
        setattr(self.mod, self.fn, self.orig)


def AttentionRanges(enabled) -> Ranges:
    return Ranges("reflecting_reality_tpu_torch.ops.attention", "dot_product_attention",
                  "attn", attention_cost, enabled)


def GroupNormRanges(enabled) -> Ranges:
    return Ranges("reflecting_reality_tpu_torch.ops.norms", "group_norm", "gn",
                  groupnorm_cost, enabled)


def roofline_share(calls: dict, device_s: dict):
    """Sum of least time over sum of device time, in %, over the ranges the
    trace saw; None when it saw none."""
    seen = [n for n in calls if device_s.get(n, 0.0) > 0.0]
    if not seen:
        return None
    return 100.0 * sum(calls[n] for n in seen) / sum(device_s[n] for n in seen)
