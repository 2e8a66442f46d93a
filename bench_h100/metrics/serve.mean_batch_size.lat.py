"""Requests per batched pipeline call over the window: the change of the
server's `batches` and `batched_requests` counters (`cli/serve.py`)."""


def read(run):
    batches = run.data.get("batches", 0)
    return run.data["batched_requests"] / batches if batches else None
