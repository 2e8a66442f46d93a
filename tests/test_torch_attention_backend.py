"""The attention backend of the port (`ops/attention.py`), on the CPU.

- `dot_product_attention(..., backend="xla")` never reaches the flash
  kernels, even for fake CUDA tensors at a flash shape with the routing rule
  patched to say flash; `None` and "flash" do reach them there.
- `set_attention_backend(module, name)` sets every `Attention` of a module
  tree, JAX's names only, and an `Attention` passes its backend to both of
  its calls (the main attention and the IP-Adapter one).
- The "xla" path against JAX's `dot_product_attention(..., backend="xla")`
  on the same inputs: fp32 at 1e-5 of the output's max, bf16 within one
  bf16 ulp of it (both round fp32 probabilities to bf16 before P V).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from reflecting_reality_tpu.ops.attention import dot_product_attention as j_attention
from reflecting_reality_tpu_torch.ops import attention
from tests.test_torch_helpers import TINY
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def test_xla_never_reaches_flash(monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or attention.attention_plain(q, k, v))
    with FakeTensorMode():
        q, k, v = (torch.empty((2, 4096, 8, 40), dtype=torch.bfloat16, device="cuda")
                   for _ in range(3))
        for backend in (None, "flash"):
            attention.dot_product_attention(q, k, v, backend)
        assert len(calls) == 2
        monkeypatch.setattr(attention, "routes_to_flash", lambda q, k: True)
        out = attention.dot_product_attention(q, k, v, "xla")
    assert len(calls) == 2 and out.shape == q.shape


def test_set_attention_backend_reaches_every_attention_and_both_calls(monkeypatch):
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel

    torch.manual_seed(0)
    unet = UNet2DConditionModel(sample_size=8, ip_num_tokens=4, **TINY)
    attns = [m for m in unet.modules() if isinstance(m, attention.Attention)]
    assert attns and {m.attention_backend for m in attns} == {"flash"}
    attention.set_attention_backend(unet, "xla")
    assert {m.attention_backend for m in attns} == {"xla"}
    with pytest.raises(AssertionError):
        attention.set_attention_backend(unet, "pallas")

    seen = []
    real = attention.dot_product_attention
    monkeypatch.setattr(attention, "dot_product_attention",
                        lambda q, k, v, backend=None: seen.append(backend) or real(q, k, v,
                                                                                   backend))
    ip_attn = next(m for m in attns if m.ip_num_tokens)
    ctx = torch.randn(1, 77 + 4, ip_attn.to_k.in_features)
    ip_attn(torch.randn(1, 16, ip_attn.to_q.in_features), ctx)
    assert seen == ["xla", "xla"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_path_matches_jax(dtype):
    rng = np.random.RandomState(0)
    q, k, v = (rng.standard_normal((2, 64, 4, 40)).astype(np.float32) for _ in range(3))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = attention.dot_product_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), backend="xla").float().numpy()
    want = np.asarray(j_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  backend="xla").astype(jnp.float32))
    scale = np.abs(want).max()
    tol = 1e-5 * scale if dtype == "float32" else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got - want).max() <= tol
