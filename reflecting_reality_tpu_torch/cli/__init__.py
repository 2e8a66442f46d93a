"""Command-line entry points of the port (counterpart of `reflecting_reality_tpu/cli/`)."""
