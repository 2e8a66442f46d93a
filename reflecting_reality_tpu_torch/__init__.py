"""PyTorch/CUDA port of reflecting_reality_tpu (MirrorFusion inference and
training).

Mirrors the JAX package's module tree: core/, ops/ (ops/kernels/ holds the
hand-written Hopper kernels that replace ops/pallas/), models/, schedulers/,
data/, pipelines/, training/, metrics/, tools/, cli/.  It imports torch,
never jax, and nothing of the JAX package.
"""
