"""Image metrics of the port (counterpart of `reflecting_reality_tpu/metrics/`)."""
