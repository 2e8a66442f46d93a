"""The port's sharded VAE decodes against the JAX package's and against the
port's own plain and tiled decodes, on the CPU in fp32.

The mesh is a tuple of 2 or 4 CPU devices (`make_mesh(devices=...)`); JAX's
runs over `make_mesh(2|4)` of the 8 host devices tests/conftest.py forces.
The weights are JAX's, jittered, carried across by
`core.io.state_dict_from_jax_params`.  Tolerances are JAX's
(tests/test_sharded_vae.py): the exact decode against the plain one at rtol
1e-4, atol 2e-5; the blended decode against the tiled one at rtol 1e-4,
atol 1e-5; each port decode against its JAX counterpart at the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.parallel.mesh import make_mesh as j_make_mesh
from reflecting_reality_tpu.parallel.sharded_vae import sharded_decode as j_sharded_decode
from reflecting_reality_tpu.parallel.sharded_vae import (
    sharded_decode_exact as j_sharded_decode_exact,
)
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.parallel.mesh import make_mesh, replicated
from reflecting_reality_tpu_torch.parallel.sharded_vae import (
    sharded_decode,
    sharded_decode_exact,
    tiled_decode,
)
from tests.test_torch_helpers import init_jax, nchw_to_nhwc, nhwc_to_nchw, randn, to_torch
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

OVERLAP = 4


def _vaes(cfg, seed, batch):
    jv = JVAE(**cfg)
    params = init_jax(jv, jnp.zeros((batch, 32, 32, 3)), jax.random.PRNGKey(9), seed=seed)
    return jv, params, to_torch(AutoencoderKL(**cfg), params)


@pytest.fixture(scope="module")
def vaes():
    return _vaes(dict(block_out_channels=(4, 4, 4, 4), norm_num_groups=2), 0, 1)


def _jax(fn, jv, params, z, n, **kw):
    mesh = j_make_mesh(n)
    return np.asarray(jax.jit(lambda p, x: fn(jv, p, x, mesh, **kw))(params, jnp.asarray(z)))


@pytest.mark.parametrize("n", [2, 4])
def test_exact_decode_matches_plain_and_jax(vaes, n):
    jv, params, vae = vaes
    z = 0.3 * randn(2, 1, 16, 32, 4)
    mesh = make_mesh(devices=["cpu"] * n)
    with torch.no_grad():
        got = sharded_decode_exact(vae, nhwc_to_nchw(z), mesh)
        plain = vae.decode(nhwc_to_nchw(z))
    assert got.shape == plain.shape == (1, 3, 128, 256)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=2e-5)
    want = _jax(j_sharded_decode_exact, jv, params, z, n)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_blended_decode_matches_tiled_and_jax(vaes, n):
    jv, params, vae = vaes
    z = 0.3 * randn(3, 1, 16, 32, 4)
    mesh = make_mesh(devices=["cpu"] * n)
    with torch.no_grad():
        got = sharded_decode(vae, nhwc_to_nchw(z), mesh, overlap=OVERLAP)
        tiled = tiled_decode(vae, nhwc_to_nchw(z), num_tiles=n, overlap=OVERLAP)
        plain = vae.decode(nhwc_to_nchw(z))
    torch.testing.assert_close(got, tiled, rtol=1e-4, atol=1e-5)
    assert (got - plain).abs().max().item() < 0.5 * plain.abs().max().item()
    want = _jax(j_sharded_decode, jv, params, z, n, overlap=OVERLAP)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=1e-4, atol=1e-5)


def test_exact_decode_channel_change_and_batch():
    """conv_shortcut (channel-changing resnets) and batch 2 (JAX :68-78)."""
    jv, params, vae = _vaes(dict(block_out_channels=(4, 8, 8, 8), norm_num_groups=2), 3, 2)
    z = 0.3 * randn(5, 2, 16, 32, 4)
    mesh = make_mesh(devices=["cpu"] * 4)
    with torch.no_grad():
        got = sharded_decode_exact(vae, nhwc_to_nchw(z), mesh)
        plain = vae.decode(nhwc_to_nchw(z))
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=2e-5)
    want = _jax(j_sharded_decode_exact, jv, params, z, 4)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=1e-4, atol=2e-5)


def test_mesh_helpers_and_the_width_check(vaes):
    _, _, vae = vaes
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh == (torch.device("cpu"),) * 3
    reps = replicated(vae, mesh)
    assert all(r is vae for r in reps)          # one device: the module itself
    with pytest.raises(ValueError, match="divisible"):
        sharded_decode_exact(vae, torch.zeros(1, 4, 8, 16), mesh)
    with pytest.raises(ValueError, match="2 devices asked for"):
        make_mesh(2, devices=["cpu"])
