"""Command-line tools of the port (counterpart of `reflecting_reality_tpu/tools/`)."""
