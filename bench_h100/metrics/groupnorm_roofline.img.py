"""GroupNorm's share of its roofline in the profiler's window: the sum
over `ops/norms.py`'s `group_norm` calls of the least time (each input and
output byte once at the HBM bandwidth) over the device time of what each
call launched."""

from bench_h100.instrument import roofline_share


def read(run):
    calls = run.data.get("groupnorm_calls")
    if not calls or run.trace_obj is None:
        return None
    return roofline_share(calls, run.trace_obj.range_device_s("bench.gn."))
