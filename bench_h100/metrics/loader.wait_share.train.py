"""% of the window the training loop waited on `prefetch_to_device`'s
iterator for its next batch."""


def read(run):
    if not run.data.get("window_s"):
        return None
    return 100.0 * run.data["loader_wait_s"] / run.data["window_s"]
