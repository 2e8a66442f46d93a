"""Device ms a training step of what the program's `rr.train.optimizer`
spans launched (the clip, AdamW and the EMA of `apply_update`): device time
by launch correlation inside each `rr.train.optimizer#<id>` range on its
thread, over the ranges the trace holds (one a step).  None on a program
without the span."""


def read(run):
    if run.trace_obj is None:
        return None
    dev = run.trace_obj.range_device_s("rr.train.optimizer#")
    return 1e3 * sum(dev.values()) / len(dev) if dev else None
