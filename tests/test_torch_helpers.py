"""Shared helpers for the PyTorch-port parity tests (this file holds no
tests): tiny configs, JAX modules with jittered parameters, and the same
weights loaded strictly into the port's modules through
`state_dict_from_jax_params`."""

import jax
import numpy as np
import torch

from reflecting_reality_tpu_torch.core.io import load_into, state_dict_from_jax_params

# tests/test_golden_pipeline.py:22-28 and tests/test_pipeline.py:22-35
TINY = dict(
    block_out_channels=(8, 16, 16, 16),
    attention_head_dim=2,
    cross_attention_dim=32,
    norm_num_groups=4,
    layers_per_block=2,
)
TINY_VAE = dict(block_out_channels=(8, 8, 8, 8), norm_num_groups=4)
TINY_TEXT = dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64)


def jitter(params, seed: int = 0, scale: float = 0.1):
    """Numpy copy of a JAX param tree with seeded noise added to every leaf,
    so zero-initialized convs, biases and unit norm scales all carry signal."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        params,
    )


def init_jax(module, *args, seed: int = 0, **kwargs):
    """Jittered numpy params of a JAX module."""
    params = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return jitter(params, seed)


def to_torch(torch_module, jax_params):
    """The port's module with the JAX weights, strict load, eval mode."""
    return load_into(torch_module, state_dict_from_jax_params(jax_params)).eval()


def nhwc_to_nchw(x) -> torch.Tensor:
    return torch.tensor(np.moveaxis(np.asarray(x), -1, 1))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().numpy(), 1, -1)


def randn(seed: int, *shape) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
