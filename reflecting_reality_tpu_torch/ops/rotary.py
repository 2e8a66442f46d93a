"""Rotary position embeddings over several axes, as FLUX.1 uses them
(reference: src/diffusers/models/embeddings.py `FluxPosEmbed`,
`get_1d_rotary_pos_embed(..., use_real=True, repeat_interleave_real=True)`
and `apply_rotary_emb`).

Each token carries one position per axis (FLUX: (0, row, col) for an image
token on the packed grid, zeros for a text token).  Axis i rotates its own
`axes_dim[i]` channels of a head: pairs (2j, 2j+1) turn by
pos * theta^(-2j / axes_dim[i]).  The angles are formed in float64, as
diffusers forms them, and the tables kept in float32; the rotation runs in
float32 and casts back to the input's dtype.  No kernel: it is elementwise
work around B1 and memory-bound.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_tables(ids: torch.Tensor, axes_dim: Sequence[int],
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, n_axes) positions -> (cos, sin), each (T, sum(axes_dim)) float32,
    every angle repeated for the two channels of its pair."""
    pos = ids.to(torch.float64)
    cos, sin = [], []
    for i, dim in enumerate(axes_dim):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                             device=ids.device)[: dim // 2] / dim)
        angles = torch.outer(pos[:, i], freqs)
        cos.append(angles.cos().repeat_interleave(2, dim=1).float())
        sin.append(angles.sin().repeat_interleave(2, dim=1).float())
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, T, H, D) by the (T, D) tables; the pairs are adjacent
    channels (x[2j], x[2j+1]) -> (x[2j] cos - x[2j+1] sin, x[2j+1] cos + x[2j] sin)."""
    real, imag = x.unflatten(-1, (-1, 2)).unbind(-1)
    rotated = torch.stack([-imag, real], dim=-1).flatten(-2)
    return (x.float() * cos[:, None] + rotated.float() * sin[:, None]).to(x.dtype)
