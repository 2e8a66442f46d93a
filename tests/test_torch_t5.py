"""The port's T5 v1.1 encoder (`models/t5.py`, FLUX.1's second text
encoder) on the CPU in fp32 at a tiny size (d_model 32, 4 heads of 8,
d_ff 48, 2 layers, 32 buckets up to distance 128): against the benchmark's
plain reference (`bench_h100/reference/flux.py`), and against an
implementation that shares neither's reading of the paper, transformers'
`T5EncoderModel` built from a `T5Config` with `feed_forward_proj=
"gated-gelu"`, given the same state dict (skipped where transformers is
missing).  300 tokens, so that offsets past `max_distance` fall into the
logarithmic buckets and their clamp.

Tolerance: 1e-5 of the output's largest value (fp32 everywhere; the
implementations sum in other orders, and transformers computes the logits
in the input dtype where the port computes them in fp32 — the same here).
The bucket function is compared exactly.
"""

import os

import pytest
import torch

from bench_h100 import weights_flux
from bench_h100.reference import flux as rf
from reflecting_reality_tpu_torch.models.t5 import T5EncoderModel, relative_position_bucket
from tests.test_torch_helpers import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
           relative_attention_num_buckets=32, relative_attention_max_distance=128,
           layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu")


@pytest.fixture(scope="module")
def t5():
    with torch.device("meta"):
        m = T5EncoderModel(**CFG)
    return weights_flux.fill("t5", m, 17, "cpu", torch.float32, d_kv=CFG["d_kv"]).eval()


def ids(t: int = 300, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG["vocab_size"], (2, t), generator=gen)


def close(a, b):
    assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def transformers_t5():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(dropout_rate=0.0, **CFG)
    return transformers.T5EncoderModel(cfg).eval(), transformers


def test_t5_takes_transformers_names(t5):
    names = set(t5.state_dict())
    assert {"shared.weight", "encoder.embed_tokens.weight", "encoder.final_layer_norm.weight",
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            "encoder.block.1.layer.0.SelfAttention.q.weight",
            "encoder.block.1.layer.1.DenseReluDense.wi_0.weight",
            "encoder.block.1.layer.1.DenseReluDense.wo.weight",
            "encoder.block.1.layer.1.layer_norm.weight"} <= names
    assert "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight" not in names
    assert t5.shared is t5.encoder.embed_tokens
    assert not any(n.endswith("bias") and "relative" not in n for n in names)


@torch.no_grad()
def test_t5_matches_the_reference(t5):
    ref = rf.build("t5", CFG)
    state = dict(t5.state_dict())
    state.pop("encoder.embed_tokens.weight")
    ref.load_state_dict(state, strict=True)
    x = ids()
    out = t5(x)
    assert out.shape == (2, 300, 32)
    close(out, ref.eval()(x))


@torch.no_grad()
def test_t5_matches_transformers(t5):
    hf, _ = transformers_t5()
    hf.load_state_dict(t5.state_dict(), strict=True)
    x = ids(seed=1)
    close(t5(x), hf(x).last_hidden_state)


def test_relative_position_buckets_match_transformers():
    _, transformers = transformers_t5()
    pos = torch.arange(300)
    rel = pos[None] - pos[:, None]
    want = transformers.models.t5.modeling_t5.T5Attention._relative_position_bucket(
        rel, bidirectional=True, num_buckets=32, max_distance=128)
    assert torch.equal(relative_position_bucket(rel, 32, 128), want)
    assert torch.equal(rf.t5_bucket(rel, 32, 128), want)


def test_t5_queries_are_drawn_with_the_folded_scale(t5):
    """The seeded draw puts T5's missing 1/sqrt(d_kv) into q's weights,
    as T5's own initialisation does."""
    sa = t5.encoder.block[0].layer[0].SelfAttention
    ratio = (sa.q.weight.std() / sa.k.weight.std()).item()
    assert ratio == pytest.approx(CFG["d_kv"] ** -0.5, rel=0.15)


def test_only_the_gated_gelu_feed_forward_is_taken():
    with pytest.raises(ValueError, match="gated-gelu"):
        T5EncoderModel(**dict(CFG, feed_forward_proj="relu"))
