"""IP-Adapter normals conditioning (counterpart of
`reflecting_reality_tpu/models/ip_adapter.py`; reference:
examples/brushnet/ip_adapter/ip_adapter.py:50-112, attention_processor.py:
282-307, wiring at train_brushnet_mirror.py:1085-1123 and :74-88).

MirrorFusion's `normals_conditioning_mode="ip_adapter"` path:
1. the dataset reduces the normals map to ONE unit vector, the mean normal
   over the mirror mask, shape (B, 1, 3);
2. `freq_encode` (NeRF-style, 32 log-spaced bands, sin/cos, no input term)
   lifts it to (B, 1, 192);
3. `NormalProjModel` (Linear 192 -> cross_attention_dim, exact GELU) makes
   it one context token, appended AFTER the 77 text tokens, for the UNet
   only (BrushNet keeps the text);
4. every cross-attention of the UNet splits off the trailing
   `ip_num_tokens` and attends to them through bias-free `to_k_ip` /
   `to_v_ip` (`ops.attention.Attention`), added with `ip_scale`.

Quirk kept verbatim: the reference builds its IP processors with their
default num_tokens=4 while appending a single normal token, so the split
also claims the last 3 text tokens; checkpoints were trained that way, so
`DEFAULT_NUM_TOKENS = 4`.

`init_ip_params_from_unet` is the weight init: each layer's `to_k_ip` /
`to_v_ip` starts as a copy of its `to_k` / `to_v` (reference :1102-1121).

`NormalProjModel`'s weights live in `ip_adapter/normal_proj.safetensors`
beside a checkpoint's `brushnet/` and `unet/`; the file keeps the JAX
package's key names (`proj_0.weight`, `proj_0.bias`), so either package
reads the other's checkpoints (`save_normal_proj` / `load_normal_proj`).
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping, Optional

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.io import load_into, load_safetensors, save_safetensors

DEFAULT_NUM_TOKENS = 4
NORMALS_EMBED_DIM = 192  # 3 dims x 32 bands x (sin, cos)
IP_NAMES = ("to_k_ip", "to_v_ip")
NORMAL_PROJ_FILE = os.path.join("ip_adapter", "normal_proj.safetensors")


def freq_encode(x: torch.Tensor, n_freqs: int = 32, max_freq_log2: float = 5.0,
                log_sampling: bool = True, include_input: bool = False) -> torch.Tensor:
    """NeRF positional encoding over the last axis (reference FreqEncoder):
    [sin(x·f0), cos(x·f0), sin(x·f1), ...] for bands f = 2^linspace(0, 5, 32)."""
    if log_sampling:
        bands = 2.0 ** torch.linspace(0.0, max_freq_log2, n_freqs, dtype=torch.float32)
    else:
        bands = torch.linspace(1.0, 2.0 ** max_freq_log2, n_freqs, dtype=torch.float32)
    parts = [x] if include_input else []
    for f in bands.tolist():
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


class NormalProjModel(nn.Module):
    """proj.0 = Linear(192 -> cross_attention_dim), then the exact GELU
    (reference ip_adapter.py:97-112)."""

    def __init__(self, cross_attention_dim: int = 768, in_dim: int = NORMALS_EMBED_DIM):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.proj = nn.Sequential(nn.Linear(in_dim, cross_attention_dim), nn.GELU())

    def forward(self, normal_embeds: torch.Tensor) -> torch.Tensor:
        return self.proj(normal_embeds)


def normal_tokens(normal: torch.Tensor, proj: NormalProjModel) -> torch.Tensor:
    """(B, 1, 3) unit mirror normal -> (B, 1, cross_attention_dim) token
    (reference get_normal_embeds, train_brushnet_mirror.py:74-88): the
    encoding in fp32, the projection in the weights' dtype (or autocast's)."""
    return proj(freq_encode(normal.float()).to(proj.proj[0].weight.dtype))


def is_ip_param_name(name: str) -> bool:
    """True for the to_k_ip / to_v_ip parameters of a UNet state dict."""
    return any(part in IP_NAMES for part in name.split("."))


def ip_parameters(module: nn.Module) -> Iterable[nn.Parameter]:
    return (p for n, p in module.named_parameters() if is_ip_param_name(n))


@torch.no_grad()
def init_ip_params_from_unet(unet: nn.Module) -> nn.Module:
    """Copy each attention layer's to_k / to_v weight into its to_k_ip /
    to_v_ip, in place (the JAX version grafts the same copies into a fresh
    tree); returns `unet`."""
    for module in unet.modules():
        for ip in IP_NAMES:
            if hasattr(module, ip):
                getattr(module, ip).weight.copy_(getattr(module, ip[:-3]).weight)
    return unet


def save_normal_proj(state: Mapping[str, torch.Tensor], checkpoint_dir: str) -> str:
    """Write a `NormalProjModel` state dict as
    `checkpoint_dir/ip_adapter/normal_proj.safetensors`, under the JAX key
    names."""
    path = os.path.join(checkpoint_dir, NORMAL_PROJ_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_safetensors({k.replace("proj.0.", "proj_0.", 1): v for k, v in state.items()}, path)
    return path


def load_normal_proj(proj: NormalProjModel, path: str) -> NormalProjModel:
    """Strict load of a normal_proj.safetensors file (JAX's `proj_0.*` or
    the torch module's `proj.0.*` names) into `proj`."""
    state = {k.replace("proj_0.", "proj.0.", 1): v.float()
             for k, v in load_safetensors(path).items()}
    return load_into(proj, state, where=path)


def build_normal_proj(cross_attention_dim: int, path: Optional[str] = None,
                      generator: Optional[torch.Generator] = None) -> NormalProjModel:
    """A `NormalProjModel` on the CPU: loaded from `path`, or freshly drawn
    (torch's Linear init) from `generator`."""
    proj = NormalProjModel(cross_attention_dim)
    if path is not None:
        return load_normal_proj(proj, path)
    if generator is not None:
        lin = proj.proj[0]
        bound = 1.0 / NORMALS_EMBED_DIM ** 0.5        # nn.Linear's kaiming-uniform bounds
        with torch.no_grad():
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
    return proj
