"""Plain PyTorch equations of FLUX.1 Fill [dev], the reference of the
`flux1-fill-dev` configuration: the MMDiT transformer, the T5 v1.1
encoder, CLIP-L's pooled output, the 16-channel VAE and the flow-matching
Euler sampler with the Fill pipeline's packing, under diffusers' and
transformers' parameter names.

A frozen copy of the equations of diffusers' transformer_flux.py
(FluxTransformer2DModel, FluxTransformerBlock, FluxSingleTransformerBlock,
FluxAttnProcessor2_0), normalization.py (AdaLayerNormZero,
AdaLayerNormZeroSingle, AdaLayerNormContinuous, RMSNorm), embeddings.py
(FluxPosEmbed, CombinedTimestepGuidanceTextProjEmbeddings),
scheduling_flow_match_euler_discrete.py and pipeline_flux_fill.py, and of
transformers' modeling_t5.py (T5EncoderModel) and CLIPTextModel's
`pooler_output`.  Every product is a float32 matmul (the caller turns TF32
off), every attention an fp32 softmax over the full logits, and nothing
here imports the program under test.  `models.QUANT` switches every
product's inputs to float8 e4m3 (the control), through `models.q`.

Departures from the published description, each also the program's:

- the timestep's and guidance's sinusoid arguments (x 1000) are formed in
  fp32 (diffusers forms them in the model's dtype);
- the latents between steps are kept in fp32;
- the tokenizers are the configuration's `assumed` hash tokenizers: CLIP
  `sampling.hash_tokens` over 77 tokens (EOS = the largest id), T5
  `t5_hash_tokens` over 512 (EOS 1, padding 0).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.models import CLIPText, Conv2d, Linear, _Coder, q, timestep_embedding
from bench_h100.reference.sampling import hash_tokens, to_uint8

EPS = 1e-6


# ------------------------------------------------------------------ pieces

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + self.eps)
        return y.to(self.weight.dtype) * self.weight


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=EPS)


def rope_tables(ids: torch.Tensor, axes: Sequence[int], theta: float = 10000.0):
    """(T, n_axes) ids -> (cos, sin) (T, sum(axes)): angles in float64, each
    repeated for its pair of channels."""
    cos, sin = [], []
    for i, dim in enumerate(axes):
        freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim)
        ang = ids[:, i].double()[:, None] * freqs[None]
        cos.append(torch.cos(ang).repeat_interleave(2, 1).float())
        sin.append(torch.sin(ang).repeat_interleave(2, 1).float())
    return torch.cat(cos, -1), torch.cat(sin, -1)


def rope(x, cos, sin):
    """(B, H, T, D) rotated pairwise by the (T, D) tables."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-x2, x1], -1).flatten(-2)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def attend(qh, kh, vh, bias=None, scale=True):
    """(B, H, T, D) -> (B, T, H x D); fp32 logits and softmax."""
    logits = torch.matmul(q(qh).float(), q(kh).float().transpose(-1, -2))
    if scale:
        logits = logits / math.sqrt(qh.shape[-1])
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, -1).to(vh.dtype)
    out = torch.matmul(q(probs), q(vh))
    return out.transpose(1, 2).flatten(2)


class MLP2(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, cout), Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class FF(nn.Module):
    """net.0.proj -> tanh-GELU -> net.2."""

    def __init__(self, dim):
        super().__init__()
        g = nn.Module()
        g.proj = Linear(dim, 4 * dim)
        self.net = nn.ModuleList([g, nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


def _lin(dim, n):
    m = nn.Module()
    m.linear = Linear(dim, n * dim)
    return m


# ------------------------------------------------------------- transformer

class Attn(nn.Module):
    def __init__(self, dim, heads, hd, joint):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (Linear(dim, heads * hd) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        if joint:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (Linear(dim, heads * hd)
                                                                 for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
            self.to_out = nn.ModuleList([Linear(heads * hd, dim), nn.Identity()])
            self.to_add_out = Linear(heads * hd, dim)

    def _h(self, x):
        b, t, _ = x.shape
        return x.view(b, t, self.heads, -1).transpose(1, 2)

    def forward(self, x, cos, sin, ctx=None):
        qh, kh, vh = (self.norm_q(self._h(self.to_q(x))), self.norm_k(self._h(self.to_k(x))),
                      self._h(self.to_v(x)))
        if ctx is not None:
            qh = torch.cat([self.norm_added_q(self._h(self.add_q_proj(ctx))), qh], 2)
            kh = torch.cat([self.norm_added_k(self._h(self.add_k_proj(ctx))), kh], 2)
            vh = torch.cat([self._h(self.add_v_proj(ctx)), vh], 2)
        out = attend(rope(qh, cos, sin), rope(kh, cos, sin), vh)
        if ctx is None:
            return out
        n = ctx.shape[1]
        return self.to_out[0](out[:, n:]), self.to_add_out(out[:, :n])


def mod(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class Double(nn.Module):
    def __init__(self, dim, heads, hd):
        super().__init__()
        self.norm1, self.norm1_context = _lin(dim, 6), _lin(dim, 6)
        self.attn = Attn(dim, heads, hd, True)
        self.ff, self.ff_context = FF(dim), FF(dim)

    def forward(self, x, ctx, temb, cos, sin):
        sh, sc, g, sh2, sc2, g2 = self.norm1.linear(F.silu(temb)).chunk(6, 1)
        csh, csc, cg, csh2, csc2, cg2 = self.norm1_context.linear(F.silu(temb)).chunk(6, 1)
        a, ca = self.attn(mod(x, sh, sc), cos, sin, mod(ctx, csh, csc))
        x = x + g[:, None] * a
        x = x + g2[:, None] * self.ff(mod(x, sh2, sc2))
        ctx = ctx + cg[:, None] * ca
        ctx = ctx + cg2[:, None] * self.ff_context(mod(ctx, csh2, csc2))
        return x, ctx


class Single(nn.Module):
    def __init__(self, dim, heads, hd):
        super().__init__()
        self.norm = _lin(dim, 3)
        self.proj_mlp = Linear(dim, 4 * dim)
        self.attn = Attn(dim, heads, hd, False)
        self.proj_out = Linear(5 * dim, dim)

    def forward(self, x, temb, cos, sin):
        sh, sc, g = self.norm.linear(F.silu(temb)).chunk(3, 1)
        h = mod(x, sh, sc)
        cat = torch.cat([self.attn(h, cos, sin), F.gelu(self.proj_mlp(h), approximate="tanh")], 2)
        return x + g[:, None] * self.proj_out(cat)


class Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
        dim = heads * hd
        self.axes = list(cfg["axes_dims_rope"])
        tte = nn.Module()
        tte.timestep_embedder = MLP2(256, dim)
        tte.guidance_embedder = MLP2(256, dim) if cfg.get("guidance_embeds") else None
        tte.text_embedder = MLP2(cfg["pooled_projection_dim"], dim)
        self.time_text_embed = tte
        self.context_embedder = Linear(cfg["joint_attention_dim"], dim)
        self.x_embedder = Linear(cfg["in_channels"], dim)
        self.transformer_blocks = nn.ModuleList([Double(dim, heads, hd)
                                                 for _ in range(cfg["num_layers"])])
        self.single_transformer_blocks = nn.ModuleList([Single(dim, heads, hd)
                                                        for _ in range(cfg["num_single_layers"])])
        self.norm_out = _lin(dim, 2)
        self.proj_out = Linear(dim, cfg.get("out_channels") or cfg["in_channels"])

    def forward(self, x, ctx, pooled, sigma, guidance, img_ids, txt_ids):
        """x (B, N, in) packed, ctx (B, L, 4096), pooled (B, 768), sigma and
        guidance (B,) -> velocity (B, N, out)."""
        tte = self.time_text_embed
        temb = tte.timestep_embedder(timestep_embedding(sigma.float() * 1000, 256).to(x.dtype))
        if tte.guidance_embedder is not None:
            temb = temb + tte.guidance_embedder(
                timestep_embedding(guidance.float() * 1000, 256).to(x.dtype))
        temb = temb + tte.text_embedder(pooled)
        cos, sin = rope_tables(torch.cat([txt_ids, img_ids]), self.axes)
        h, c = self.x_embedder(x), self.context_embedder(ctx)
        for blk in self.transformer_blocks:
            h, c = blk(h, c, temb, cos, sin)
        n = c.shape[1]
        h = torch.cat([c, h], 1)
        for blk in self.single_transformer_blocks:
            h = blk(h, temb, cos, sin)
        scale, shift = self.norm_out.linear(F.silu(temb)).chunk(2, 1)
        return self.proj_out(layer_norm(h[:, n:]) * (1 + scale[:, None]) + shift[:, None])


# --------------------------------------------------------------------- T5

def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


class T5(nn.Module):
    """transformers' T5EncoderModel names -> the last hidden state."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, inner, heads = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["num_heads"]
        self.cfg = cfg
        self.shared = nn.Embedding(cfg["vocab_size"], d)
        enc = nn.Module()
        enc.block = nn.ModuleList()
        for i in range(cfg["num_layers"]):
            sa = nn.Module()
            sa.q, sa.k, sa.v = (Linear(d, inner, bias=False) for _ in range(3))
            sa.o = Linear(inner, d, bias=False)
            if i == 0:
                sa.relative_attention_bias = nn.Embedding(cfg["relative_attention_num_buckets"],
                                                          heads)
            l0, l1 = nn.Module(), nn.Module()
            l0.SelfAttention, l0.layer_norm = sa, RMSNorm(d, cfg["layer_norm_epsilon"])
            ff = nn.Module()
            ff.wi_0, ff.wi_1 = (Linear(d, cfg["d_ff"], bias=False) for _ in range(2))
            ff.wo = Linear(cfg["d_ff"], d, bias=False)
            l1.DenseReluDense, l1.layer_norm = ff, RMSNorm(d, cfg["layer_norm_epsilon"])
            blk = nn.Module()
            blk.layer = nn.ModuleList([l0, l1])
            enc.block.append(blk)
        enc.final_layer_norm = RMSNorm(d, cfg["layer_norm_epsilon"])
        self.encoder = enc

    def forward(self, ids):
        cfg, heads = self.cfg, self.cfg["num_heads"]
        t = ids.shape[1]
        pos = torch.arange(t, device=ids.device)
        bucket = t5_bucket(pos[None] - pos[:, None], cfg["relative_attention_num_buckets"],
                           cfg["relative_attention_max_distance"])
        bias = (self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias(bucket)
                .float().permute(2, 0, 1)[None])
        x = self.shared(ids)
        b = x.shape[0]
        for blk in self.encoder.block:
            l0, l1 = blk.layer
            sa, h = l0.SelfAttention, l0.layer_norm(x)
            qh, kh, vh = (p(h).view(b, t, heads, -1).transpose(1, 2) for p in (sa.q, sa.k, sa.v))
            x = x + sa.o(attend(qh, kh, vh, bias, scale=False))
            h = l1.layer_norm(x)
            ff = l1.DenseReluDense
            x = x + ff.wo(F.gelu(ff.wi_0(h), approximate="tanh") * ff.wi_1(h))
        return self.encoder.final_layer_norm(x)


# -------------------------------------------------------------- CLIP, VAE

class CLIPPooled(CLIPText):
    """CLIP-L's `pooler_output`: the final state at each row's largest id."""

    def forward(self, ids):
        last = super().forward(ids)[0]
        return last[torch.arange(ids.shape[0], device=ids.device), ids.argmax(1)]


class VAE(nn.Module):
    """The 16-channel KL VAE: the SD coder blocks (`models._Coder`) with
    16-channel ends and no quant convs."""

    def __init__(self, cfg: dict):
        super().__init__()
        bocs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        g = cfg["norm_num_groups"]
        zc = cfg["latent_channels"]
        self.encoder = _Coder(bocs, lpb, g, True)
        self.encoder.conv_out = Conv2d(bocs[-1], 2 * zc, 3, padding=1)
        self.decoder = _Coder(bocs, lpb, g, False)
        self.decoder.conv_in = Conv2d(zc, bocs[-1], 3, padding=1)

    def encode_mean(self, x):
        return self.encoder(x).chunk(2, 1)[0]

    def decode(self, z):
        return self.decoder(z)


def build(kind: str, cfg: dict) -> nn.Module:
    return {"transformer": Transformer, "t5": T5, "clip": CLIPPooled, "vae": VAE}[kind](cfg)


# ------------------------------------------------------- sampler, packing

def sigmas(steps: int, image_tokens: int, base_len=256, max_len=4096, base_shift=0.5,
           max_shift=1.15) -> np.ndarray:
    """linspace(1, 1/steps, steps) shifted at mu = the line through
    (base_len, base_shift) and (max_len, max_shift) at `image_tokens`,
    sigma -> e^mu / (e^mu + 1/sigma - 1); then 0.  float32."""
    mu = base_shift + (max_shift - base_shift) * (image_tokens - base_len) / (max_len - base_len)
    s = np.linspace(1.0, 1.0 / steps, steps)
    return np.append(np.exp(mu) / (np.exp(mu) + 1.0 / s - 1.0), 0.0).astype(np.float32)


def euler(x, v, s, s_next):
    return x.float() + (float(s_next) - float(s)) * v.float()


def pack(x):
    """(B, C, H, W) -> (B, H/2 W/2, 4C): channel c*4 + 2 dy + dx."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, -1, 4 * c)


def unpack(x, h, w):
    b, _, c4 = x.shape
    return x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        b, c4 // 4, h, w)


def img_ids(hp: int, wp: int, device) -> torch.Tensor:
    ids = torch.zeros(hp, wp, 3, device=device)
    ids[..., 1] += torch.arange(hp, device=device)[:, None]
    ids[..., 2] += torch.arange(wp, device=device)[None]
    return ids.reshape(-1, 3)


def t5_hash_tokens(texts: Sequence[str], vocab_size: int = 32128, length: int = 512):
    out = np.zeros((len(texts), length), np.int64)
    for i, t in enumerate(texts):
        ids = [2 + zlib.crc32(w.encode()) % (vocab_size - 2)
               for w in t.lower().split()[:length - 1]] + [1]
        out[i, :len(ids)] = ids
    return out


# ---------------------------------------------------------------- a call

def context(mods: Dict[str, nn.Module], cfg: dict, prompt: str, image: np.ndarray,
            mask: np.ndarray, device, max_len: int = 512):
    """A request's text states, pooled vector and packed conditioning
    (B=1, fp32): `image` HWC in [0, 1], `mask` HW in {0, 1} (1 = fill)."""
    vae_cfg = cfg["vae"]
    ids = torch.from_numpy(hash_tokens([prompt], cfg["clip"]["vocab_size"])).to(device)
    pooled = mods["clip"](ids)
    ids2 = torch.from_numpy(t5_hash_tokens([prompt], cfg["t5"]["vocab_size"], max_len)).to(device)
    states = mods["t5"](ids2)
    cond = conditioning(mods["vae"], vae_cfg, image, mask, device)
    return states, pooled, cond


def conditioning(vae, vae_cfg: dict, image: np.ndarray, mask: np.ndarray, device):
    img = torch.from_numpy(np.ascontiguousarray(image, np.float32) * 2.0 - 1.0)
    img = img.permute(2, 0, 1)[None].to(device)
    m = torch.from_numpy(np.ascontiguousarray(mask, np.float32))[None].to(device)
    z = (vae.encode_mean(img * (1.0 - m[:, None])) - vae_cfg["shift_factor"]) \
        * vae_cfg["scaling_factor"]
    b, h, w = m.shape
    folded = m.reshape(b, h // 8, 8, w // 8, 8).permute(0, 2, 4, 1, 3).reshape(b, 64, h // 8,
                                                                               w // 8)
    return torch.cat([pack(z), pack(folded)], -1)


def velocity(mods, x_lat, states, pooled, cond, sigma: float, guidance: float):
    """The transformer's velocity at packed latents x_lat (B, N, 64)."""
    b, n, _ = x_lat.shape
    side = int(round(math.sqrt(n)))
    dev = x_lat.device
    return mods["transformer"](torch.cat([x_lat.float(), cond], -1), states, pooled,
                               torch.full((b,), float(sigma), device=dev),
                               torch.full((b,), float(guidance), device=dev),
                               img_ids(side, side, dev), torch.zeros(states.shape[1], 3,
                                                                     device=dev)).float()


def decode(vae, vae_cfg: dict, lat: torch.Tensor, px: int) -> torch.Tensor:
    """Packed latents -> (H, W, 3) uint8."""
    z = unpack(lat, px // 8, px // 8) / vae_cfg["scaling_factor"] + vae_cfg["shift_factor"]
    return to_uint8(vae.decode(z))[0].permute(1, 2, 0)


@torch.no_grad()
def generate(mods, cfg: dict, prompt: str, image, mask, noise: torch.Tensor, steps: int,
             guidance: float, max_len: int = 512) -> torch.Tensor:
    """A whole Fill call from (1, 16, H/8, W/8) noise -> (H, W, 3) uint8."""
    states, pooled, cond = context(mods, cfg, prompt, image, mask, noise.device, max_len)
    lat = pack(noise.float())
    sig = sigmas(steps, lat.shape[1])
    for k in range(steps):
        lat = euler(lat, velocity(mods, lat, states, pooled, cond, sig[k], guidance),
                    sig[k], sig[k + 1])
    return decode(mods["vae"], cfg["vae"], lat, image.shape[0])
