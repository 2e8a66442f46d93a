"""Seeded weights of the FLUX.1 Fill configuration, drawn on the device a
parameter at a time and handed alike to the program's modules and to the
reference's.

`weights.py` draws a module kind in one standard-normal call, which at
11.9 B parameters would be a 47.6 GB fp32 tensor before the module exists;
here each kind (`transformer`, `t5`, `clip`, `vae`) has its own generator
(seed, kind) from which the parameters are drawn one after the other in
sorted name order, so the values still depend on the names and shapes
alone.  The scaling is `weights._scale`'s (matrices and kernels by
1/sqrt(fan_in), norm scales around 1, biases small), with one addition:
T5's query projections are drawn a further 1/sqrt(d_kv) smaller, where T5's
own initialisation puts the attention's missing 1/sqrt(d) scaling.  The
values are bf16 numbers in any dtype, as in `weights.py`.  The module is
materialised in its target dtype first, so a bf16 module never exists in
fp32.
"""

from __future__ import annotations

import math

import torch

from bench_h100.weights import _scale

KINDS = ("transformer", "t5", "clip", "vae")


def fill(kind: str, module: torch.nn.Module, seed: int, device, dtype: torch.dtype,
         d_kv: int = 0) -> torch.nn.Module:
    """Materialise `module` (built on the meta device) on `device` in
    `dtype` with the seeded values; `d_kv` is T5's head size."""
    module.to(dtype).to_empty(device=device)
    gen = torch.Generator(device).manual_seed((int(seed) * len(KINDS) + KINDS.index(kind))
                                              % (2 ** 63))
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            mul, add = _scale(name, tuple(p.shape))
            if d_kv and name.endswith("SelfAttention.q.weight"):
                mul /= math.sqrt(d_kv)
            flat = torch.randn(p.numel(), generator=gen, device=device, dtype=torch.float32)
            p.copy_((flat.view(p.shape) * mul + add).to(torch.bfloat16))
            del flat
    return module
