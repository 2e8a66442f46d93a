"""Shared helpers for the PyTorch-port parity tests (this file holds no
tests): the one-thread fixture every port test module imports, tiny
configs, JAX modules with jittered parameters, and the same weights loaded
strictly into the port's modules through `state_dict_from_jax_params`.
JAX is imported where it is used, so the card's tests, which run where JAX
is absent, can import the fixture."""

import os

import numpy as np
import pytest
import torch

from reflecting_reality_tpu_torch.core.io import load_into, state_dict_from_jax_params

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch at one intra-op thread for the module that imports this, and
    the count it found put back after.  The suite runs several workers side
    by side, each beside XLA's own pool; at torch's default of a thread a
    core the tiny ops here fight for the cores (one 5-step CLI case took
    16 s at one thread and 630 s at the default inside the suite)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def one_thread_env() -> dict:
    """The environment for a child process of a port test: torch at one
    thread there too."""
    return dict(os.environ, OMP_NUM_THREADS="1")


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
    import jax

    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        params,
    )


def init_jax(module, *args, seed: int = 0, **kwargs):
    """Jittered numpy params of a JAX module."""
    import jax

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


def port_and_jax(cls, seed: int, **cfg):
    """A port module with seeded, jittered weights (norm scales off one, zero
    inits non-zero), eval mode, and the same weights as a JAX param tree
    through the JAX package's own `torch_to_flax_params` (initialising a
    JAX UNet or BrushNet eagerly costs most of a minute on the CPU)."""
    from reflecting_reality_tpu.core.io import torch_to_flax_params

    torch.manual_seed(seed)
    module = cls(**cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    state = {k: v.numpy() for k, v in module.state_dict().items()}
    return module, {"params": torch_to_flax_params(state)}


def unet_route_counts(pipe, call) -> tuple:
    """call() -> (its change of pipe.stats()'s calls and steps, the UNet's
    attention modules, its change of the UNet's attention calls by route)."""
    from reflecting_reality_tpu_torch.ops.attention import Attention

    before = pipe.stats()
    call()
    after = pipe.stats()
    routes = {r: after["attention"]["unet"][r] - before["attention"]["unet"][r]
              for r in ("flash", "plain")}
    return ((after["calls"] - before["calls"], after["steps"] - before["steps"]),
            sum(isinstance(m, Attention) for m in pipe.unet.modules()), routes)
