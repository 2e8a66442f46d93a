"""% of rank 0's traced window spent on the device in what
`parallel/multihost.py`'s `all_reduce_mean` launched (the bucket copies,
NCCL's all-reduce and the division), device time by the profiler's launch
correlation."""


def read(run):
    dev, window = run.data.get("allreduce_device_s"), run.data.get("traced_window_s")
    if dev is None or not window:
        return None
    return 100.0 * dev / window
