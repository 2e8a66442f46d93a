"""Median device-timeline ms between consecutive denoise steps of one
pipeline call: CUDA events recorded at each UNet forward's start by the
benchmark's pre-hook, no synchronise in the loop."""

import statistics


def read(run):
    ms = run.data.get("step_ms")
    return statistics.median(ms) if ms else None
