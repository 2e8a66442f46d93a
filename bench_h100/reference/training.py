"""The reference's training step: the MirrorFusion loss on a batch drawn
from the latent cache (posterior draws, DDPM noising, BrushNet's residuals
into the UNet, MSE against the noise), its backward pass, clipping by the
global norm and AdamW with decoupled weight decay, in plain PyTorch.

A frozen copy of train_brushnet_mirror.py's step as the recipe runs it
(`--train_base_unet`, epsilon prediction, no SNR weighting).  The random
numbers are the step's own: a generator seeded with the run's seed on the
run's device, drawn in the step's order (the two posterior draws, the
noise, the timesteps), so the reference reproduces them.  The gradient of
the batch mean is accumulated row by row, so that the fp32 step fits.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from bench_h100.reference.sampling import scaled_linear_alphas_cumprod


def step_draws(gen: torch.Generator, b: int, hl: int, wl: int, device) -> Dict[str, torch.Tensor]:
    shape = (b, 4, hl, wl)
    return {"latents": torch.randn(shape, generator=gen, device=device),
            "cond": torch.randn(shape, generator=gen, device=device),
            "noise": torch.randn(shape, generator=gen, device=device),
            "timesteps": torch.randint(0, 1000, (b,), generator=gen, device=device)}


def row_loss(mods, batch: Dict[str, torch.Tensor], draws, r: int, sf: float) -> torch.Tensor:
    """The loss of batch row r (NHWC arrays on the device)."""
    def nchw(x):
        return x[r:r + 1].permute(0, 3, 1, 2).float()

    def sample(moments, noise):
        mean, logvar = nchw(moments).chunk(2, 1)
        return (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise[r:r + 1]) * sf

    latents = sample(batch["latent_moments"], draws["latents"])
    cond = torch.cat([sample(batch["cond_latent_moments"], draws["cond"]),
                      nchw(batch["masks"]), nchw(batch["depths"])], 1)
    with torch.no_grad():
        ehs = mods["text_encoder"](batch["input_ids"][r:r + 1])[0]
    acp = torch.from_numpy(scaled_linear_alphas_cumprod()).to(latents.device)
    t = draws["timesteps"][r:r + 1]
    a = acp[t].reshape(-1, 1, 1, 1)
    noise = draws["noise"][r:r + 1]
    noisy = a.sqrt() * latents + (1.0 - a).sqrt() * noise
    down, mid, up = mods["brushnet"](noisy, t, ehs, cond)
    pred = mods["unet"](noisy, t, ehs, down, mid, up)
    return ((pred.float() - noise) ** 2).mean()


class AdamW:
    """torch/optax AdamW: p <- p(1 - lr wd); m, v moments; p -= lr m^/(sqrt(v^) + eps)."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m / c1, (v / c2).sqrt().add_(self.eps), value=-self.lr)


def train_steps(mods, names: List[str], params: List[torch.Tensor], batches, gen, sf: float,
                lr: float, max_grad_norm: float, wd: float) -> Dict[str, list]:
    """len(batches) steps -> losses, the first step's clipped gradient norms
    by leaf and each leaf's change after the last step."""
    opt = AdamW(params, lr, weight_decay=wd)
    start = [p.detach().clone() for p in params]
    losses, grad_norms = [], None
    for batch in batches:
        b, hl, wl = batch["latent_moments"].shape[:3]
        draws = step_draws(gen, b, hl, wl, params[0].device)
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for r in range(b):
            loss = row_loss(mods, batch, draws, r, sf) / b
            for g, d in zip(grads, torch.autograd.grad(loss, params, allow_unused=True)):
                if d is not None:
                    g.add_(d)
            total += float(loss.detach())
        losses.append(total)
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        if norm >= max_grad_norm:
            for g in grads:
                g.mul_(max_grad_norm / norm)
        if grad_norms is None:
            grad_norms = [float(g.double().norm()) for g in grads]
        opt.step(grads)
        del grads
    changes = [float((p.detach().double() - s.double()).norm()) for p, s in zip(params, start)]
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes, "names": names}


def leaf_gaps(program: List[float], reference: List[float], keep: List[bool]) -> List[float]:
    """Each kept leaf's |program norm - reference norm| over the larger of
    the reference's norm and the median kept leaf's."""
    ref = np.asarray(reference, np.float64)
    med = float(np.median(ref[np.asarray(keep)]))
    return [abs(p - r) / max(r, med) for p, r, k in zip(program, reference, keep) if k]


def readings(program: dict, reference: dict) -> Dict[str, float]:
    """The compared numbers of a training check: the first step's loss
    (relative gap), the first step's clipped gradient by its worst leaf, and
    the change after the checked steps by the median leaf, leaving out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding: they move by round-off alone)."""
    med = float(np.median(reference["grad_norms"]))
    keep = [g >= 1e-3 * med for g in reference["grad_norms"]]
    l_p, l_r = program["losses"][0], reference["losses"][0]
    changes = leaf_gaps(program["changes"], reference["changes"], keep)
    return {"loss1_rel": abs(l_p - l_r) / abs(l_r),
            "grad_leaf_gap": max(leaf_gaps(program["grad_norms"], reference["grad_norms"],
                                           [True] * len(keep))),
            "change_median_gap": float(np.median(changes)),
            "change_worst_gap": max(changes), "left_out": sum(not k for k in keep)}
