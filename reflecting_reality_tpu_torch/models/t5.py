"""The T5 v1.1 encoder, FLUX.1's second text encoder (reference:
transformers `T5EncoderModel`, modeling_t5.py: T5Stack, T5Block,
T5LayerSelfAttention, T5Attention, T5LayerFF, T5DenseGatedActDense,
T5LayerNorm).  Parameter names are transformers', so a published
`text_encoder_2/` folder loads unchanged.

- `shared` token embeddings (also `encoder.embed_tokens`, the same module)
  -> `num_layers` pre-norm blocks -> `encoder.final_layer_norm`.
- Norms are RMSNorms with a scale and no bias (`ops.norms.RMSNorm`: T5's
  `T5LayerNorm`), eps `layer_norm_epsilon`.
- Self-attention has no bias and no 1/sqrt(d) scaling (T5 folds it into
  the initialisation of q); its logits carry a learned bias by relative
  position, bidirectional, in `relative_attention_num_buckets` buckets up to
  `relative_attention_max_distance`, owned by block 0's attention and shared
  by every block.  No padding mask: FLUX pads every prompt to 512 tokens
  and attends over the padding too.
- Feed-forward "gated-gelu": wo(gelu_tanh(wi_0 x) * wi_1 x).

The position bias and the missing scaling keep this attention off B1
(`ops.attention.dot_product_attention` computes softmax(q k^T / sqrt(d)) v
with nothing added), so it runs here in plain PyTorch: fp32 logits and
softmax, probabilities cast back before P V.  At 512 tokens that is
(B, 64, 512, 512) fp32 logits a layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.ops.norms import RMSNorm


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of each (key - query) offset: half the
    buckets for each sign, exact up to a quarter of them, then
    logarithmic up to `max_distance`."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(n < max_exact, n, large)


class _SelfAttention(nn.Module):
    def __init__(self, d_model, d_kv, heads, buckets: int = 0, max_distance: int = 128):
        super().__init__()
        inner = heads * d_kv
        self.heads, self.d_kv = heads, d_kv
        self.q, self.k, self.v = (nn.Linear(d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, d_model, bias=False)
        self.buckets, self.max_distance = buckets, max_distance
        if buckets:
            self.relative_attention_bias = nn.Embedding(buckets, heads)

    def position_bias(self, t: int, device) -> torch.Tensor:
        """(1, heads, t, t) fp32."""
        pos = torch.arange(t, device=device)
        bucket = relative_position_bucket(pos[None, :] - pos[:, None], self.buckets,
                                          self.max_distance)
        return self.relative_attention_bias(bucket).float().permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def heads(y):
            return y.view(b, t, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.o(torch.matmul(probs, v).transpose(1, 2).reshape(b, t, -1))


class _Layer(nn.Module):
    """`layer.0` (self-attention) or `layer.1` (feed-forward) of a block."""

    def __init__(self, d_model: int, eps: float):
        super().__init__()
        self.layer_norm = RMSNorm(d_model, eps)


class _GatedFF(nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
        self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _Block(nn.Module):
    def __init__(self, d_model, d_kv, d_ff, heads, eps, buckets, max_distance):
        super().__init__()
        attn, ff = _Layer(d_model, eps), _Layer(d_model, eps)
        attn.SelfAttention = _SelfAttention(d_model, d_kv, heads, buckets, max_distance)
        ff.DenseReluDense = _GatedFF(d_model, d_ff)
        self.layer = nn.ModuleList([attn, ff])

    def forward(self, x, bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5EncoderModel(nn.Module, ConfigMixin):
    def __init__(self, vocab_size: int = 32128, d_model: int = 4096, d_kv: int = 64,
                 d_ff: int = 10240, num_layers: int = 24, num_heads: int = 64,
                 relative_attention_num_buckets: int = 32,
                 relative_attention_max_distance: int = 128,
                 layer_norm_epsilon: float = 1e-6, feed_forward_proj: str = "gated-gelu"):
        super().__init__()
        if feed_forward_proj != "gated-gelu":
            raise ValueError(f"only T5 v1.1's gated-gelu feed-forward is ported, not "
                             f"{feed_forward_proj!r}")
        self.vocab_size, self.d_model, self.d_kv, self.d_ff = vocab_size, d_model, d_kv, d_ff
        self.num_layers, self.num_heads = num_layers, num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.layer_norm_epsilon, self.feed_forward_proj = layer_norm_epsilon, feed_forward_proj
        self.shared = nn.Embedding(vocab_size, d_model)
        enc = nn.Module()
        enc.embed_tokens = self.shared
        enc.block = nn.ModuleList([
            _Block(d_model, d_kv, d_ff, num_heads, layer_norm_epsilon,
                   relative_attention_num_buckets if i == 0 else 0,
                   relative_attention_max_distance)
            for i in range(num_layers)])
        enc.final_layer_norm = RMSNorm(d_model, layer_norm_epsilon)
        self.encoder = enc

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, d_model) last hidden state."""
        enc = self.encoder
        x = self.shared(input_ids)
        bias = enc.block[0].layer[0].SelfAttention.position_bias(input_ids.shape[1],
                                                                 input_ids.device)
        for block in enc.block:
            x = block(x, bias)
        return enc.final_layer_norm(x)
