"""The SD-inpainting baseline (counterpart of `reflecting_reality_tpu/baseline/`)."""
