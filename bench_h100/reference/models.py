"""Plain PyTorch model equations of the benchmark's reference: the SD-1.5 /
SDXL UNet with BrushNet's additive injections, the conv-only BrushNet
branch, the KL VAE and the CLIP text towers, under the diffusers parameter
names, NCHW.

A frozen copy of the equations (diffusers' unet_2d_condition.py,
unet_2d_blocks.py, resnet.py, transformer_2d.py, attention.py,
autoencoder_kl.py, brushnet.py; transformers' CLIP text model).  Every
GroupNorm is `F.group_norm`, every attention an fp32 softmax over the full
logits, and nothing here imports the program under test.

`QUANT` is the reference's precision switch: None computes in the input
dtype (float32 for the reference), "fp8" passes the inputs of every
convolution, linear layer and attention product through float8 e4m3 with a
per-tensor scale (the control of the bf16 cells: the step below bf16).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QUANT: Optional[str] = None


def q(x: torch.Tensor) -> torch.Tensor:
    """x through the reference's precision switch (straight-through for
    autograd)."""
    if QUANT is None:
        return x
    if QUANT != "fp8":
        raise ValueError(QUANT)
    scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach()


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(q(x), q(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(q(x), q(self.weight), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, silu: bool = False):
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if silu else y


def attention(qt, kt, vt, heads: int):
    """(B, T, heads*D) q, k, v -> (B, Tq, heads*D); fp32 logits and softmax."""
    b, tq, c = qt.shape
    tk, d = kt.shape[1], c // heads
    qh = qt.reshape(b, tq, heads, d).transpose(1, 2)
    kh = kt.reshape(b, tk, heads, d).transpose(1, 2)
    vh = vt.reshape(b, tk, heads, d).transpose(1, 2)
    logits = torch.matmul(q(qh).float(), q(kh).float().transpose(-1, -2)) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    return torch.matmul(q(probs), q(vh)).transpose(1, 2).reshape(b, tq, c)


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool = True, shift: float = 0.0):
    half = dim // 2
    ex = -math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device)
    emb = t.float()[:, None] * torch.exp(ex / (half - shift))[None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], -1)
    return torch.cat([emb[:, half:], emb[:, :half]], -1) if flip else emb


class MLP2(nn.Module):
    """linear_1 -> silu -> linear_2 (the time and text_time embeddings)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, cout), Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


# ----------------------------------------------------------------- blocks

class Resnet(nn.Module):
    def __init__(self, cin, cout, groups=32, eps=1e-5, temb=1280):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, True))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Down(nn.Module):
    def __init__(self, c, pad=1):
        super().__init__()
        self.pad = pad
        self.conv = Conv2d(c, c, 3, stride=2, padding=pad)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.pad == 0 else x)


class Up(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x, size=None):
        return self.conv(F.interpolate(x, size=size, mode="nearest") if size
                         else F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attn(nn.Module):
    """to_q/to_k/to_v/to_out (self when ctx is None); `group_norm` and the
    residual for the VAE's spatial attention."""

    def __init__(self, dim, heads, dim_head, ctx_dim=None, bias=False, groups=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.group_norm = GroupNorm(groups, dim, 1e-6) if groups else None
        self.to_q = Linear(dim, inner, bias=bias)
        self.to_k = Linear(ctx_dim or dim, inner, bias=bias)
        self.to_v = Linear(ctx_dim or dim, inner, bias=bias)
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])

    def forward(self, x, ctx=None):
        if self.group_norm is not None:            # spatial (VAE)
            b, c, h, w = x.shape
            t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
            out = self.to_out[0](attention(self.to_q(t), self.to_k(t), self.to_v(t), self.heads))
            return out.transpose(1, 2).reshape(b, c, h, w) + x
        ctx = x if ctx is None else ctx
        return self.to_out[0](attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, -1)
        return h * F.gelu(gate)


class FF(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Block(nn.Module):
    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))
        self.attn1 = Attn(dim, heads, dim // heads)
        self.attn2 = Attn(dim, heads, dim // heads, ctx_dim)
        self.ff = FF(dim)

    def forward(self, x, ctx):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), ctx) + x
        return self.ff(self.norm3(x)) + x


class Transformer2D(nn.Module):
    def __init__(self, c, heads, layers, ctx_dim, groups, linear_proj):
        super().__init__()
        self.linear = linear_proj
        self.norm = GroupNorm(groups, c, 1e-6)
        self.proj_in = Linear(c, c) if linear_proj else Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([Block(c, heads, ctx_dim) for _ in range(layers)])
        self.proj_out = Linear(c, c) if linear_proj else Conv2d(c, c, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        t = self.norm(x)
        if self.linear:
            t = self.proj_in(t.reshape(b, c, h * w).transpose(1, 2))
        else:
            t = self.proj_in(t).reshape(b, c, h * w).transpose(1, 2)
        for blk in self.transformer_blocks:
            t = blk(t, ctx)
        if self.linear:
            t = self.proj_out(t).transpose(1, 2).reshape(b, c, h, w)
        else:
            t = self.proj_out(t.transpose(1, 2).reshape(b, c, h, w))
        return t + x


def _take(adds: Optional[List[torch.Tensor]], x):
    return x + adds.pop(0) if adds else x


class DownBlock(nn.Module):
    def __init__(self, cin, cout, n, down, attn, eps, groups, temb, **t):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin if i == 0 else cout, cout, groups, eps, temb)
                                      for i in range(n)])
        if attn:
            self.attentions = nn.ModuleList([Transformer2D(cout, groups=groups, **t)
                                             for _ in range(n)])
        self.attn = attn
        self.downsamplers = nn.ModuleList([Down(cout)]) if down else None

    def forward(self, x, temb, ctx, adds=None):
        states = ()
        for i, r in enumerate(self.resnets):
            x = r(x, temb)
            if self.attn:
                x = self.attentions[i](x, ctx)
            x = _take(adds, x)
            states += (x,)
        if self.downsamplers is not None:
            x = _take(adds, self.downsamplers[0](x))
            states += (x,)
        return x, states


class UpBlock(nn.Module):
    def __init__(self, cin, prev, cout, n, up, attn, eps, groups, temb, **t):
        super().__init__()
        self.resnets = nn.ModuleList([
            Resnet((prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout, groups, eps,
                   temb)
            for i in range(n)])
        if attn:
            self.attentions = nn.ModuleList([Transformer2D(cout, groups=groups, **t)
                                             for _ in range(n)])
        self.attn = attn
        self.upsamplers = nn.ModuleList([Up(cout)]) if up else None

    def forward(self, x, skips, temb, ctx, adds=None, capture=False, size=None):
        got, skips = (), list(skips)
        for i, r in enumerate(self.resnets):
            x = r(torch.cat([x, skips.pop()], 1), temb)
            if self.attn:
                x = self.attentions[i](x, ctx)
            got += (x,) if capture else ()
            x = _take(adds, x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
            got += (x,) if capture else ()
            x = _take(adds, x)
        return x, got


class MidBlock(nn.Module):
    def __init__(self, c, attn, eps, groups, temb, **t):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(c, c, groups, eps, temb) for _ in range(2)])
        if attn:
            self.attentions = nn.ModuleList([Transformer2D(c, groups=groups, **t)])
        self.attn = attn

    def forward(self, x, temb, ctx):
        x = self.resnets[0](x, temb)
        if self.attn:
            x = self.attentions[0](x, ctx)
        return self.resnets[1](x, temb)


# ---------------------------------------------------------- UNet, BrushNet

class _Twin(nn.Module):
    """The UNet's trunk; BrushNet is the same trunk with every block
    conv-only, `conv_in_condition` and the 28 zero-conv outputs."""

    def __init__(self, cfg: dict, brushnet: bool):
        super().__init__()
        bocs = list(cfg["block_out_channels"])
        n, lpb = len(bocs), cfg["layers_per_block"]
        heads = cfg["attention_head_dim"]
        heads = list(heads) if isinstance(heads, (list, tuple)) else [heads] * n
        tl = cfg.get("transformer_layers_per_block", 1)
        tl = list(tl) if isinstance(tl, (list, tuple)) else [tl] * n
        eps, groups = cfg["norm_eps"], cfg["norm_num_groups"]
        self.cfg, self.brushnet, self.lpb = cfg, brushnet, lpb
        temb = bocs[0] * 4
        if brushnet:
            self.conv_in_condition = Conv2d(4 + cfg["conditioning_channels"], bocs[0], 3,
                                            padding=1)
        else:
            self.conv_in = Conv2d(4, bocs[0], 3, padding=1)
        self.time_embedding = MLP2(bocs[0], temb)
        self.add_embedding = (MLP2(cfg["projection_class_embeddings_input_dim"], temb)
                              if cfg.get("addition_embed_type") == "text_time" else None)

        def tkw(i):
            return dict(heads=heads[i], layers=tl[i], ctx_dim=cfg["cross_attention_dim"],
                        linear_proj=cfg.get("use_linear_projection", False))

        self.down_blocks = nn.ModuleList()
        for i, bt in enumerate(cfg["down_block_types"]):
            attn = bt.startswith("CrossAttn") and not brushnet
            self.down_blocks.append(DownBlock(bocs[max(i - 1, 0)], bocs[i], lpb, i < n - 1, attn,
                                              eps, groups, temb, **(tkw(i) if attn else {})))
        mid_attn = not brushnet
        self.mid_block = MidBlock(bocs[-1], mid_attn, eps, groups, temb,
                                  **(tkw(n - 1) if mid_attn else {}))
        self.up_blocks = nn.ModuleList()
        rb = bocs[::-1]
        for i, bt in enumerate(cfg["up_block_types"]):
            attn = bt.startswith("CrossAttn") and not brushnet
            j = n - 1 - i
            self.up_blocks.append(UpBlock(rb[min(i + 1, n - 1)], rb[max(i - 1, 0)], rb[i],
                                          lpb + 1, i < n - 1, attn, eps, groups, temb,
                                          **(tkw(j) if attn else {})))
        if brushnet:
            downs = [bocs[0]] + [c for i, c in enumerate(bocs)
                                 for _ in range(lpb + (1 if i < n - 1 else 0))]
            ups = [c for i, c in enumerate(rb) for _ in range(lpb + 1 + (1 if i < n - 1 else 0))]
            self.brushnet_down_blocks = nn.ModuleList([Conv2d(c, c, 1) for c in downs])
            self.brushnet_mid_block = Conv2d(bocs[-1], bocs[-1], 1)
            self.brushnet_up_blocks = nn.ModuleList([Conv2d(c, c, 1) for c in ups])
        else:
            self.conv_norm_out = GroupNorm(groups, bocs[0], eps)
            self.conv_out = Conv2d(bocs[0], 4, 3, padding=1)

    def temb(self, t: torch.Tensor, added: Optional[dict]) -> torch.Tensor:
        bocs = self.cfg["block_out_channels"]
        emb = self.time_embedding(timestep_embedding(t, bocs[0]).to(
            self.time_embedding.linear_1.weight.dtype))
        if self.add_embedding is not None:
            ids = added["time_ids"]
            tid = timestep_embedding(ids.reshape(-1), self.cfg["addition_time_embed_dim"])
            aug = torch.cat([added["text_embeds"].float(), tid.reshape(ids.shape[0], -1)], -1)
            emb = emb + self.add_embedding(aug.to(emb.dtype))
        return emb


class UNet(_Twin):
    def __init__(self, cfg):
        super().__init__(cfg, brushnet=False)

    def forward(self, x, t, ctx, down_adds=None, mid_add=None, up_adds=None, added=None):
        emb = self.temb(t.reshape(-1).expand(x.shape[0]), added)
        down_adds = list(down_adds) if down_adds is not None else None
        up_adds = list(up_adds) if up_adds is not None else None
        x = self.conv_in(x)
        skips = (x,)
        x = _take(down_adds, x)
        for blk in self.down_blocks:
            x, st = blk(x, emb, ctx, down_adds)
            skips += st
        x = self.mid_block(x, emb, ctx)
        if mid_add is not None:
            x = x + mid_add
        skips, k = list(skips), self.lpb + 1
        for blk in self.up_blocks:
            res, skips = skips[-k:], skips[:-k]
            x, _ = blk(x, res, emb, ctx, up_adds, size=tuple(skips[-1].shape[2:]) if skips else None)
        return self.conv_out(self.conv_norm_out(x, True))


class BrushNet(_Twin):
    def __init__(self, cfg):
        super().__init__(cfg, brushnet=True)

    def forward(self, x, t, ctx, cond, scale: float = 1.0, added=None):
        emb = self.temb(t.reshape(-1).expand(x.shape[0]), added)
        x = self.conv_in_condition(torch.cat([x, cond], 1))
        states = (x,)
        for blk in self.down_blocks:
            x, st = blk(x, emb, ctx)
            states += st
        down = [c(s) * scale for c, s in zip(self.brushnet_down_blocks, states)]
        x = self.mid_block(x, emb, ctx)
        mid = self.brushnet_mid_block(x) * scale
        skips, k, ups = list(states), self.lpb + 1, ()
        for blk in self.up_blocks:
            res, skips = skips[-k:], skips[:-k]
            x, got = blk(x, res, emb, ctx, capture=True,
                         size=tuple(skips[-1].shape[2:]) if skips else None)
            ups += got
        return down, mid, [c(s) * scale for c, s in zip(self.brushnet_up_blocks, ups)]


# -------------------------------------------------------------------- VAE

class _Coder(nn.Module):
    def __init__(self, bocs, lpb, groups, encoder: bool):
        super().__init__()
        self.encoder = encoder
        if encoder:
            self.conv_in = Conv2d(3, bocs[0], 3, padding=1)
            self.down_blocks = nn.ModuleList()
            for i, c in enumerate(bocs):
                blk = nn.Module()
                blk.resnets = nn.ModuleList([Resnet(bocs[max(i - 1, 0)] if j == 0 else c, c,
                                                    groups, 1e-6, None) for j in range(lpb)])
                blk.downsamplers = (nn.ModuleList([Down(c, pad=0)]) if i < len(bocs) - 1
                                    else None)
                self.down_blocks.append(blk)
            top = bocs[-1]
        else:
            top = bocs[-1]
            self.conv_in = Conv2d(4, top, 3, padding=1)
            self.up_blocks = nn.ModuleList()
            rb = bocs[::-1]
            for i, c in enumerate(rb):
                blk = nn.Module()
                blk.resnets = nn.ModuleList([Resnet(rb[max(i - 1, 0)] if j == 0 else c, c,
                                                    groups, 1e-6, None) for j in range(lpb + 1)])
                blk.upsamplers = nn.ModuleList([Up(c)]) if i < len(rb) - 1 else None
                self.up_blocks.append(blk)
        mid = nn.Module()
        mid.resnets = nn.ModuleList([Resnet(top, top, groups, 1e-6, None) for _ in range(2)])
        mid.attentions = nn.ModuleList([Attn(top, 1, top, bias=True, groups=groups)])
        self.mid_block = mid
        last = bocs[-1] if encoder else bocs[0]
        self.conv_norm_out = GroupNorm(groups, last, 1e-6)
        self.conv_out = Conv2d(last, 8 if encoder else 3, 3, padding=1)

    def _mid(self, x):
        m = self.mid_block
        return m.resnets[1](m.attentions[0](m.resnets[0](x)))

    def forward(self, x):
        x = self.conv_in(x)
        if self.encoder:
            for blk in self.down_blocks:
                for r in blk.resnets:
                    x = r(x)
                if blk.downsamplers is not None:
                    x = blk.downsamplers[0](x)
            x = self._mid(x)
        else:
            x = self._mid(x)
            for blk in self.up_blocks:
                for r in blk.resnets:
                    x = r(x)
                if blk.upsamplers is not None:
                    x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x, True))


class VAE(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        bocs, lpb, g = list(cfg["block_out_channels"]), cfg["layers_per_block"], cfg["norm_num_groups"]
        self.encoder = _Coder(bocs, lpb, g, True)
        self.decoder = _Coder(bocs, lpb, g, False)
        self.quant_conv = Conv2d(8, 8, 1)
        self.post_quant_conv = Conv2d(4, 4, 1)

    def encode_moments(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, 1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ------------------------------------------------------------------- CLIP

class _ClipLayer(nn.Module):
    def __init__(self, c, heads, inner):
        super().__init__()
        self.heads = heads
        self.layer_norm1, self.layer_norm2 = nn.LayerNorm(c), nn.LayerNorm(c)
        sa = nn.Module()
        sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj = (Linear(c, c) for _ in range(4))
        self.self_attn = sa
        mlp = nn.Module()
        mlp.fc1, mlp.fc2 = Linear(c, inner), Linear(inner, c)
        self.mlp = mlp

    def forward(self, x, mask):
        b, t, c = x.shape
        d = c // self.heads
        h = self.layer_norm1(x)
        sa = self.self_attn

        def heads(y):
            return y.reshape(b, t, self.heads, d).transpose(1, 2)

        logits = torch.matmul(q(heads(sa.q_proj(h))).float(),
                              q(heads(sa.k_proj(h))).float().transpose(-1, -2)) / d ** 0.5 + mask
        out = torch.matmul(q(torch.softmax(logits, -1).to(x.dtype)), q(heads(sa.v_proj(h))))
        x = x + sa.out_proj(out.transpose(1, 2).reshape(b, t, c))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """`text_model.*` names; `projection_dim` adds `text_projection` (SDXL's
    second encoder).  -> (last hidden, penultimate hidden, pooled or None)."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg["hidden_size"]
        tm = nn.Module()
        emb = nn.Module()
        emb.token_embedding = nn.Embedding(cfg["vocab_size"], c)
        emb.position_embedding = nn.Embedding(cfg["max_position_embeddings"], c)
        tm.embeddings = emb
        enc = nn.Module()
        enc.layers = nn.ModuleList([_ClipLayer(c, cfg["num_attention_heads"],
                                               cfg["intermediate_size"])
                                    for _ in range(cfg["num_hidden_layers"])])
        tm.encoder = enc
        tm.final_layer_norm = nn.LayerNorm(c)
        self.text_model = tm
        self.eos = cfg.get("eos_token_id")
        self.text_projection = (Linear(c, cfg["projection_dim"], bias=False)
                                if cfg.get("projection_dim") else None)

    def forward(self, ids: torch.Tensor):
        tm, t = self.text_model, ids.shape[1]
        pos = torch.arange(t, device=ids.device)[None]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)[None, None]
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            states.append(x)
        last = tm.final_layer_norm(x)
        pooled = None
        if self.text_projection is not None:
            eos = (ids == self.eos).int().argmax(1)
            pooled = self.text_projection(last[torch.arange(ids.shape[0], device=ids.device), eos])
        return last, states[-2], pooled


def build(kind: str, cfg: dict) -> nn.Module:
    return {"unet": UNet, "brushnet": BrushNet, "vae": VAE, "text_encoder": CLIPText,
            "text_encoder_2": CLIPText}[kind](cfg)


def parameter_shapes(module: nn.Module) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]
