"""Attention's share of its roofline in the profiler's window: the sum
over `dot_product_attention` calls of the least time (FLOPs at the bf16
peak or bytes at the HBM bandwidth, whichever is larger, from the call's
shapes) over the sum of the device time of what each call launched, so it
reads the same work whatever kernel implements it."""

from bench_h100.instrument import roofline_share


def read(run):
    calls = run.data.get("attention_calls")
    if not calls or run.trace_obj is None:
        return None
    return roofline_share(calls, run.trace_obj.range_device_s("bench.attn."))
