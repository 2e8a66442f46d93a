"""Model FLOPs of a cell's work, counted by the reference's own modules on
the meta device under `torch.utils.flop_counter.FlopCounterMode`, at the
cell's shapes: never from the program's execution.  Recomputation is not
counted."""

from __future__ import annotations

import functools
import json


@functools.lru_cache(maxsize=None)
def _train_sample(cfg_json: str, batch: int, px: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from bench_h100.reference.models import build

    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        unet, brushnet = build("unet", cfg["unet"]), build("brushnet", cfg["brushnet"])
        text = build("text_encoder", cfg["text_encoder"]).requires_grad_(False)
        hl = px // 8
        x = torch.randn(batch, 4, hl, hl)
        cond = torch.randn(batch, cfg["brushnet"]["conditioning_channels"], hl, hl)
        ids = torch.zeros(batch, 77, dtype=torch.long)
        t = torch.zeros(batch, dtype=torch.long)
        with FlopCounterMode(display=False) as counter:
            ehs = text(ids)[0]
            down, mid, up = brushnet(x, t, ehs, cond)
            unet(x, t, ehs, down, mid, up).float().pow(2).mean().backward()
    return counter.get_total_flops() / batch


def train_flops_per_sample(cfg: dict, batch: int, px: int) -> float:
    """Text encode, BrushNet and UNet forward, their backward (every
    parameter of both trains, as `--train_base_unet` asks)."""
    return _train_sample(json.dumps(cfg, sort_keys=True), batch, px)


@functools.lru_cache(maxsize=None)
def _image(cfg_json: str, px: int, steps: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from bench_h100.reference.models import build

    cfg = json.loads(cfg_json)
    hl = px // 8
    with torch.device("meta"), torch.no_grad():
        mods = {k: build(k, cfg[k]) for k in ("unet", "brushnet", "vae", "text_encoder",
                                                "text_encoder_2") if k in cfg}
        ids = torch.zeros(1, 77, dtype=torch.long)
        with FlopCounterMode(display=False) as text:
            mods["text_encoder"](ids)
            if "text_encoder_2" in mods:
                mods["text_encoder_2"](ids)
        with FlopCounterMode(display=False) as vae:
            mods["vae"].encode_moments(torch.randn(1, 3, px, px))
            mods["vae"].decode(torch.randn(1, 4, hl, hl))
        x = torch.randn(2, 4, hl, hl)
        ctx = torch.randn(2, 77, cfg["unet"]["cross_attention_dim"])
        cond = torch.randn(2, cfg["brushnet"]["conditioning_channels"], hl, hl)
        t = torch.zeros(2, dtype=torch.long)
        added = None
        if cfg["unet"].get("addition_embed_type") == "text_time":
            added = {"text_embeds": torch.randn(2, cfg["text_encoder_2"]["projection_dim"]),
                     "time_ids": torch.zeros(2, 6)}
        with FlopCounterMode(display=False) as step:
            down, mid, up = mods["brushnet"](x, t, ctx, cond, added=added)
            mods["unet"](x, t, ctx, down, mid, up, added=added)
    return (text.get_total_flops() + vae.get_total_flops()
            + steps * step.get_total_flops())


def image_flops(cfg: dict, px: int, steps: int) -> float:
    """One image: the text encoders, the VAE encode and decode, and each
    step's BrushNet and UNet at the CFG batch of 2 (BrushNet at 2 too: the
    SD-1.5 path runs it once at batch 1, so this counts its model FLOPs as
    the SDXL path spends them)."""
    return _image(json.dumps(cfg, sort_keys=True), px, steps)
