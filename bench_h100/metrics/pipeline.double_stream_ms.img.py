"""Device ms a denoise step of what FLUX's double-stream blocks launched:
the device time of every operation whose launch (by the profiler's launch
correlation) falls inside an `rr.flux.double#<id>` range on its thread,
over the ranges the trace holds (one a transformer forward).  None on a
program without the span."""


def read(run):
    if run.trace_obj is None:
        return None
    dev = run.trace_obj.range_device_s("rr.flux.double#")
    return 1e3 * sum(dev.values()) / len(dev) if dev else None
