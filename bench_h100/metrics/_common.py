"""Helpers the metric readers share (not a metric: the harness looks up
`metrics/<name>.py` by a metric's name)."""


def idle_share(run):
    """% of the traced window in which no operation ran on the device; over
    several ranks, the largest."""
    shares = run.data.get("idle_shares")
    if shares:
        return 100.0 * max(shares)
    share = run.trace_obj.idle_share() if run.trace_obj is not None else None
    return None if share is None else 100.0 * share
