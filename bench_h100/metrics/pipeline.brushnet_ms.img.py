"""Device ms a denoise step of what the program's `rr.brushnet` spans
launched: the device time of every operation whose launch (matched by the
profiler's launch correlation) falls inside an `rr.brushnet#<id>` range on
its thread, over the ranges the trace holds (one a denoise step).  None on
a program without the span."""


def read(run):
    if run.trace_obj is None:
        return None
    dev = run.trace_obj.range_device_s("rr.brushnet#")
    return 1e3 * sum(dev.values()) / len(dev) if dev else None
