"""The reference's inference path: the hash tokenizer, the image
preparation, the conditioning latents, UniPC (bh2, predict-x0, order 2,
lower-order final) with classifier-free guidance, and the decode to uint8.

A frozen copy of diffusers' pipeline_brushnet.py and
scheduling_unipc_multistep.py as MirrorFusion runs them, in plain PyTorch
and NumPy; the initial noise is the first draw of a generator seeded with
the request's seed on the request's device, as the served path draws it.
"""

from __future__ import annotations

import zlib
from typing import Dict, Sequence

import numpy as np
import torch


def hash_tokens(texts: Sequence[str], vocab_size: int = 49408, length: int = 77) -> np.ndarray:
    """Stable ids: BOS 1, crc32 of each lower-cased word, EOS vocab-1, zero
    padding (the configuration's `assumed` tokenizer)."""
    out = np.zeros((len(texts), length), np.int64)
    for i, t in enumerate(texts):
        ids = ([1] + [2 + zlib.crc32(w.encode()) % (vocab_size - 3)
                      for w in t.lower().split()[:length - 2]] + [vocab_size - 1])
        out[i, :len(ids)] = ids
    return out


def scaled_linear_alphas_cumprod(n: int = 1000, start: float = 0.00085, end: float = 0.012):
    betas = np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float32) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


class UniPC:
    """UniPC multistep, bh2, predict_x0, solver order 2 with lower-order
    final and the corrector, "linspace" timesteps; fp32 scalars."""

    def __init__(self, steps: int, acp: np.ndarray):
        n_train = len(acp)
        self.n = steps
        ts = np.linspace(0, n_train - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
        sig_all = ((1.0 - acp) / acp) ** 0.5
        sig = np.concatenate([np.interp(ts, np.arange(n_train), sig_all),
                              [((1.0 - acp[0]) / acp[0]) ** 0.5]]).astype(np.float32)
        alpha = 1.0 / np.sqrt(1.0 + sig ** 2)
        self.timesteps = ts
        self.alpha = torch.from_numpy(alpha.astype(np.float32))
        self.sigma = torch.from_numpy((sig * alpha).astype(np.float32))
        self.lam = torch.from_numpy((np.log(alpha) - np.log(sig * alpha)).astype(np.float32))

    @staticmethod
    def _b(h):
        phi = torch.expm1(h)
        k1 = phi / h - 1.0
        k2 = k1 / h - 0.5
        return k1 / phi, 2.0 * k2 / phi, phi

    def run(self, x: torch.Tensor, eps_fn) -> torch.Tensor:
        """x_T -> x_0 with eps_fn(x, i) the guided noise prediction."""
        lam, a, s = self.lam, self.alpha, self.sigma
        m_prev = last = None
        for i in range(self.n):
            x0 = (x.float() - s[i] * eps_fn(x, i).float()) / a[i]
            p_pred = min(2, self.n - i, i + 1)
            p_corr = min(2, self.n - i + 1, i)
            if i >= 1:                                   # corrector on the incoming sample
                h = lam[i] - lam[i - 1]
                b0, b1, phi = self._b(-h)
                d1 = x0 - m_prev
                if p_corr == 2:
                    r1 = (lam[max(i - 2, 0)] - lam[i - 1]) / h
                    rho0 = (b0 - b1) / (1.0 - r1)
                    rhot = (b1 - r1 * b0) / (1.0 - r1)
                    mix = rho0 * ((m_prev2 - m_prev) / r1) + rhot * d1
                else:
                    mix = 0.5 * d1
                xf = s[i] / s[i - 1] * last - a[i] * phi * m_prev - a[i] * phi * mix
            else:
                xf = x.float()
            h = lam[i + 1] - lam[i]
            b0, _, phi = self._b(-h)
            nxt = s[i + 1] / s[i] * xf - a[i + 1] * phi * x0
            if p_pred >= 2:
                r1 = (lam[i - 1] - lam[i]) / h
                nxt = nxt - a[i + 1] * phi * 0.5 * ((m_prev - x0) / r1)
            m_prev2, m_prev, last, x = m_prev, x0, xf, nxt
        return x


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


def conditioning(vae, image: np.ndarray, mask: np.ndarray, depth: np.ndarray,
                 device, sf: float) -> torch.Tensor:
    """HWC [0, 1] image, mask (white = hole) and depth -> the conditioning
    latents (1, 6, h/8, w/8): the VAE mean of the image x sf, the
    nearest-downsampled keep mask (1 = keep) and depth, in [-1, 1]."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).permute(2, 0, 1)[None].to(device)

    img = dev(image * 2.0 - 1.0)
    keep = dev(((mask * 2.0 - 1.0).sum(-1, keepdims=True) < 0).astype(np.float32))
    dep = dev(depth[..., :1] * 2.0 - 1.0)
    h, w = image.shape[:2]
    rows = torch.arange(h // 8, device=device) * h // (h // 8)
    cols = torch.arange(w // 8, device=device) * w // (w // 8)
    mean, _ = vae.encode_moments(img)
    return torch.cat([mean * sf, keep[:, :, rows][:, :, :, cols],
                      dep[:, :, rows][:, :, :, cols]], 1)


@torch.no_grad()
def generate_sd15(mods: Dict[str, torch.nn.Module], prompt: str, image, mask, depth, seed: int,
                  steps: int, guidance: float, device, sf: float, vocab: int) -> torch.Tensor:
    """One request through the SD-1.5 BrushNet path -> (H, W, 3) uint8."""
    ids = torch.from_numpy(hash_tokens(["", prompt], vocab)).to(device)
    ctx = mods["text_encoder"](ids)[0]                       # [uncond, cond]
    cond = conditioning(mods["vae"], image, mask, depth, device, sf)
    h, w = image.shape[:2]
    gen = torch.Generator(device).manual_seed(int(seed))
    x = torch.randn((1, 4, h // 8, w // 8), generator=gen, device=device, dtype=torch.float32)
    sampler = UniPC(steps, scaled_linear_alphas_cumprod())
    unet, brushnet = mods["unet"], mods["brushnet"]

    def eps(lat, i):
        t = torch.tensor(int(sampler.timesteps[i]), device=device)
        down, mid, up = brushnet(lat, t, ctx[1:], cond)
        two = torch.cat([lat, lat])
        pred = unet(two, t, ctx, [torch.cat([d, d]) for d in down], torch.cat([mid, mid]),
                    [torch.cat([u, u]) for u in up])
        un, tx = pred.float().chunk(2)
        return un + float(np.float32(guidance)) * (tx - un)

    lat = sampler.run(x, eps)
    return to_uint8(mods["vae"].decode(lat / sf))[0].permute(1, 2, 0)


def sdxl_context(mods: Dict[str, torch.nn.Module], prompt: str, image, mask, depth, device,
                 sf: float, vocab: int):
    """What an SDXL request conditions every step on -> (text context at
    the CFG batch, the `text_time` inputs, the conditioning latents at the
    CFG batch): the two encoders' penultimate states side by side and
    encoder 2's pooled projection, zeros for the empty negative prompt, the
    size and crop micro-conditioning (h, w, 0, 0, h, w)."""
    ids = torch.from_numpy(hash_tokens([prompt], vocab)).to(device)
    pen1 = mods["text_encoder"](ids)[1]
    _, pen2, pooled = mods["text_encoder_2"](ids)
    pos = torch.cat([pen1, pen2], -1)
    h, w = image.shape[:2]
    added = {"text_embeds": torch.cat([torch.zeros_like(pooled), pooled]),
             "time_ids": torch.tensor([[h, w, 0, 0, h, w]] * 2, dtype=torch.float32,
                                      device=device)}
    cond = conditioning(mods["vae"], image, mask, depth, device, sf)
    return torch.cat([torch.zeros_like(pos), pos]), added, torch.cat([cond, cond])


def sdxl_pred(mods, ctx, added, cond2, lat: torch.Tensor, t: int) -> torch.Tensor:
    """The UNet's noise predictions [uncond, cond] at latent `lat` (1, 4,
    h, w) and timestep t: BrushNet at the full CFG batch, its residuals
    into the UNet."""
    tt = torch.tensor(int(t), device=lat.device)
    two = torch.cat([lat, lat])
    down, mid, up = mods["brushnet"](two, tt, ctx, cond2, added=added)
    return mods["unet"](two, tt, ctx, down, mid, up, added=added).float()


def guided(pred: torch.Tensor, guidance: float) -> torch.Tensor:
    un, tx = pred.float().chunk(2)
    return un + float(np.float32(guidance)) * (tx - un)


def sdxl_eps(mods, ctx, added, cond2, lat: torch.Tensor, t: int, guidance: float):
    """The guided noise prediction at latent `lat` and timestep t."""
    return guided(sdxl_pred(mods, ctx, added, cond2, lat, t), guidance)


@torch.no_grad()
def generate_sdxl(mods: Dict[str, torch.nn.Module], prompt: str, image, mask, depth, seed: int,
                  steps: int, guidance: float, device, sf: float, vocab: int) -> torch.Tensor:
    """One request through the SDXL BrushNet path -> (H, W, 3) uint8."""
    ctx, added, cond2 = sdxl_context(mods, prompt, image, mask, depth, device, sf, vocab)
    h, w = image.shape[:2]
    gen = torch.Generator(device).manual_seed(int(seed))
    x = torch.randn((1, 4, h // 8, w // 8), generator=gen, device=device, dtype=torch.float32)
    sampler = UniPC(steps, scaled_linear_alphas_cumprod())
    lat = sampler.run(x, lambda lat, i: sdxl_eps(mods, ctx, added, cond2, lat,
                                                 sampler.timesteps[i], guidance))
    return to_uint8(mods["vae"].decode(lat / sf))[0].permute(1, 2, 0)
