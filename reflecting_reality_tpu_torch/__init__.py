"""PyTorch/CUDA port of reflecting_reality_tpu (MirrorFusion inference).

Mirrors the JAX package's module tree: core/, ops/ (ops/kernels/ holds the
hand-written Hopper kernels that replace ops/pallas/), models/, schedulers/,
data/, pipelines/.  It imports torch, never jax, and nothing of the JAX
package.
"""
