"""PyTorch/CUDA port of reflecting_reality_tpu (MirrorFusion inference and
training).

Mirrors the JAX package's module tree: core/, ops/ (ops/kernels/ holds the
hand-written Hopper kernels that replace ops/pallas/), models/, schedulers/,
data/, pipelines/, training/, metrics/, tools/, cli/.  It imports torch,
never jax, and nothing of the JAX package.
"""

from importlib import import_module
from typing import Any

_LAZY = {
    "enable_compilation_cache": "reflecting_reality_tpu_torch.core.jit_cache",
}


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(module), name)
