"""Work splitting across processes (counterpart of `reflecting_reality_tpu/parallel/`)."""
