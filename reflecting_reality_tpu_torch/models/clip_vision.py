"""CLIP vision tower (ViT) with projection, the image half of CLIP_Similarity
and Aesthetic_Score; the port's counterpart of
`reflecting_reality_tpu/models/clip_vision.py` (reference: metrics/metrics.py:
86-106 and :191-194 reach it through open_clip / torchmetrics.clip_score
with openai/clip-vit-large-patch14).

Parameter names follow transformers' CLIPVisionModelWithProjection
(`vision_model.embeddings/encoder/...`, `visual_projection`), so the
checkpoint loads strictly.  The layers are the text tower's `_CLIPLayer`
without a mask; the 257-token attention stays plain, as in JAX (T < 2048).
`clip_preprocess` is the CLIP transform on the host: bicubic resize of the
shorter side to `image_size`, centre crop, [0, 1], CLIP mean/std; it
returns NHWC numpy, as JAX's does, and the model takes NCHW tensors.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.models.clip_text import _CLIPLayer

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(image: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8/float HWC (any size) -> (1, S, S, 3) CLIP-normalized."""
    from reflecting_reality_tpu_torch.data.synmirror import _center_crop, _resize_shorter_bicubic

    x = np.asarray(image)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    x = _center_crop(_resize_shorter_bicubic(x.astype(np.float32), image_size), image_size)
    x = (x - CLIP_MEAN) / CLIP_STD
    return x[None]


class _VisionEmbeddings(nn.Module):
    def __init__(self, hidden_size: int, image_size: int, patch_size: int):
        super().__init__()
        n = (image_size // patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(hidden_size).normal_(std=0.02))
        self.patch_embedding = nn.Conv2d(3, hidden_size, patch_size, stride=patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(n + 1, hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)  # (B, N, C)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class _VisionEncoder(nn.Module):
    def __init__(self, hidden_size, num_layers, num_heads, intermediate_size):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(hidden_size, num_heads, intermediate_size)
                                     for _ in range(num_layers)])

    def forward(self, x):
        no_mask = x.new_zeros((1, 1, 1, 1), dtype=torch.float32)   # bidirectional
        for layer in self.layers:
            x = layer(x, no_mask)
        return x


class _VisionModel(nn.Module):
    def __init__(self, hidden_size, num_hidden_layers, num_attention_heads, intermediate_size,
                 image_size, patch_size):
        super().__init__()
        self.embeddings = _VisionEmbeddings(hidden_size, image_size, patch_size)
        self.pre_layrnorm = nn.LayerNorm(hidden_size, eps=1e-5)
        self.encoder = _VisionEncoder(hidden_size, num_hidden_layers, num_attention_heads,
                                      intermediate_size)
        self.post_layernorm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, pixel_values):
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return x, self.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(nn.Module, ConfigMixin):
    def __init__(self, hidden_size: int = 1024, num_hidden_layers: int = 24,
                 num_attention_heads: int = 16, intermediate_size: int = 4096,
                 image_size: int = 224, patch_size: int = 14, projection_dim: int = 768):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.image_size = image_size
        self.patch_size = patch_size
        self.projection_dim = projection_dim
        self.vision_model = _VisionModel(hidden_size, num_hidden_layers, num_attention_heads,
                                         intermediate_size, image_size, patch_size)
        self.visual_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, S, S) -> (last hidden (B, N+1, H), image embeds (B, proj))."""
        last, pooled = self.vision_model(pixel_values)
        return last, self.visual_projection(pooled)


def load_vision_encoder(path: str, subfolder: Optional[str] = None
                        ) -> CLIPVisionModelWithProjection:
    """A strict load (CPU, fp32) from a transformers CLIPVisionModelWithProjection
    folder, or from a whole CLIP folder (`vision_config` in its config; the
    text tower's tensors are left out of the load)."""
    from reflecting_reality_tpu_torch.core.io import empty_module, load_into, load_safetensors

    root = os.path.join(path, subfolder) if subfolder else path
    cfg = {}
    cfg_path = os.path.join(root, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        cfg = raw.get("vision_config", raw)
    module = empty_module(CLIPVisionModelWithProjection, cfg)
    for name in ("model.safetensors", "pytorch_model.safetensors"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            weights = load_safetensors(p)
            break
    else:
        raise FileNotFoundError(f"no vision encoder weights under {root}")
    weights = {k: v.float() for k, v in weights.items()
               if k.startswith(("vision_model.", "visual_projection."))
               and not k.endswith("position_ids")}
    return load_into(module, weights, where=root)
