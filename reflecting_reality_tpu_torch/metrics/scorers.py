"""Scorer models of the text-alignment and image-quality metric families,
the port's counterpart of `reflecting_reality_tpu/metrics/scorers.py`
(reference: metrics/metrics.py — CLIP_Similarity through torchmetrics
clip_score :191-194, Aesthetic_Score through a LAION linear head over
open_clip ViT-L image features :86-106,167-182).

`build_extra_scorers` returns the `extra_scorers` dict MetricsCalculator
takes, built from local checkpoint files:

    clip_path:       a transformers CLIP checkpoint folder with both towers
                     (openai/clip-vit-large-patch14 layout)
    aesthetic_head:  the LAION sa_0_4_vit_l_14_linear.pth torch file

The towers run on `device` (default the card).  Image_Reward and HPS_V2.1
stay hooks that take callables (metrics/reward_models.py)."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import resolve_device


def build_extra_scorers(
    clip_path: Optional[str] = None,
    aesthetic_head: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Callable]:
    scorers: Dict[str, Callable] = {}
    if clip_path is None:
        return scorers
    device = resolve_device(device)

    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
    from reflecting_reality_tpu_torch.models.clip_vision import (
        clip_preprocess, load_vision_encoder,
    )

    vision = load_vision_encoder(clip_path).to(device, dtype).eval()

    @torch.inference_mode()
    def image_embed(image: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(clip_preprocess(np.asarray(image), vision.image_size))
        emb = vision(x.permute(0, 3, 1, 2).to(device, dtype))[1].float()
        return emb / emb.norm(dim=-1, keepdim=True)

    # CLIP similarity needs the text tower with its projection
    has_text = os.path.isdir(os.path.join(clip_path, "text_encoder")) or os.path.exists(
        os.path.join(clip_path, "vocab.json"))
    if has_text:
        try:
            text = load_text_encoder(clip_path, subfolder="", with_projection=True) \
                .to(device, dtype).eval()
            tokenizer = CLIPTokenizer.from_pretrained(clip_path)
        except (FileNotFoundError, KeyError):
            text = None
        if text is not None:
            @torch.inference_mode()
            def clip_similarity(image, caption) -> float:
                """torchmetrics clip_score: 100 * max(cos(img, txt), 0)."""
                ie = image_embed(image)
                ids = torch.as_tensor(np.asarray(tokenizer([caption])), dtype=torch.long,
                                      device=device)
                te = text(ids)[1].float()
                te = te / te.norm(dim=-1, keepdim=True)
                return float(torch.clamp((ie * te).sum(), min=0.0) * 100.0)

            scorers["CLIP_Similarity"] = clip_similarity

    if aesthetic_head is not None and os.path.exists(aesthetic_head):
        sd = torch.load(aesthetic_head, map_location="cpu")
        w = sd["weight"].float().to(device)     # (1, 768)
        b = sd["bias"].float().to(device)       # (1,)

        def aesthetic(image, caption) -> float:
            ie = image_embed(image)
            return float(ie @ w.T + b)

        scorers["Aesthetic_Score"] = aesthetic

    return scorers
