"""% of the profiler's window in which no operation ran on the card: 1 -
the union of the device's operation intervals over the traced wall time."""

from bench_h100.metrics._common import idle_share


def read(run):
    return idle_share(run)
