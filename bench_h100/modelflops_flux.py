"""Model FLOPs of one FLUX.1 Fill image, counted by the reference's own
modules (`reference/flux.py`) on the meta device under
`torch.utils.flop_counter.FlopCounterMode`, at the cell's shapes: never
from the program's execution."""

from __future__ import annotations

import functools
import json


@functools.lru_cache(maxsize=None)
def _image(cfg_json: str, px: int, steps: int) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from bench_h100.reference.flux import build, img_ids

    cfg = json.loads(cfg_json)
    tr, max_len = cfg["transformer"], int(cfg["max_sequence_length"])
    n = (px // 16) ** 2
    with torch.device("meta"), torch.no_grad():
        mods = {k: build(k, cfg[k]) for k in ("transformer", "t5", "clip", "vae")}
        with FlopCounterMode(display=False) as once:
            mods["clip"](torch.zeros(1, 77, dtype=torch.long))
            mods["t5"](torch.zeros(1, max_len, dtype=torch.long))
            mods["vae"].encode_mean(torch.randn(1, 3, px, px))
            mods["vae"].decode(torch.randn(1, cfg["vae"]["latent_channels"], px // 8, px // 8))
        with FlopCounterMode(display=False) as step:
            mods["transformer"](torch.randn(1, n, tr["in_channels"]),
                                torch.randn(1, max_len, tr["joint_attention_dim"]),
                                torch.randn(1, tr["pooled_projection_dim"]), torch.zeros(1),
                                torch.zeros(1), img_ids(px // 16, px // 16, "meta"),
                                torch.zeros(max_len, 3))
    return once.get_total_flops() + steps * step.get_total_flops()


def image_flops(cfg: dict, px: int, steps: int) -> float:
    """One image: CLIP and T5 once, the VAE encode of the masked image and
    the decode, and `steps` transformer forwards over the joint sequence."""
    return _image(json.dumps(cfg, sort_keys=True), px, steps)
