"""Seeded weights, made on the device in a few large calls and handed alike
to the program's modules and to the reference's.

Every module kind gets its own generator (seed, kind); its parameters are
taken in sorted name order as consecutive slices of one standard-normal
draw, so the values depend on the names and shapes alone, never on how a
module class orders its parameters.  Each slice is scaled as an
initialisation would: matrices and kernels by 1/sqrt(fan_in), norm scales
around 1, biases small.  The values are bf16 numbers in any dtype, so a
module held in fp32 (the reference, training's masters) starts from the
same weights as one held in bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

KINDS = ("unet", "brushnet", "vae", "text_encoder", "text_encoder_2")


def _scale(name: str, shape: Tuple[int, ...]):
    """-> (multiplier, offset) of the standard-normal slice."""
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith("weight"):                    # GroupNorm / LayerNorm scale
        return 0.05, 1.0
    return 0.02, 0.0


def draw(kind: str, shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for one module kind, in `dtype` on `device`."""
    shapes = sorted(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device).manual_seed((int(seed) * len(KINDS) + KINDS.index(kind))
                                              % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        mul, add = _scale(name, shape)
        # bf16 values, the type the cells serve in, whatever `dtype` holds them
        out[name] = (flat[at:at + n].view(shape) * mul + add).to(torch.bfloat16).to(dtype)
        at += n
    del flat
    return out


def fill(kind: str, module: torch.nn.Module, seed: int, device, dtype: torch.dtype) -> None:
    """Materialise `module` (built on the meta device) on `device` in `dtype`
    with the seeded values."""
    module.to_empty(device=device)
    values = draw(kind, [(n, tuple(p.shape)) for n, p in module.named_parameters()],
                  seed, device, dtype)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.data = values.pop(n)
    module.to(dtype)
