"""CUDA runtime and driver launch calls (kernels and graphs) in the
profiler's window, per denoise step that started in it."""


def read(run):
    steps = run.data.get("profiler_steps", 0)
    if run.trace_obj is None or not steps:
        return None
    return run.trace_obj.launches() / steps
