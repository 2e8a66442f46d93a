"""Tiled VAE decode (counterpart of `tiled_decode` and its helpers in
`reflecting_reality_tpu/parallel/sharded_vae.py:38-108`).

The decoder splits into a head (post_quant_conv -> conv_in -> mid block,
where the global attention lives; run whole) and a tail (conv-only up
blocks, GroupNorm+SiLU, conv_out; a finite receptive field).  The tail runs
over `num_tiles` overlapping strips of the latent width, each widened by
`overlap` latent columns on either side, and the strips are cross-faded
with linear ramps over their overlaps (the diffusers enable_vae_tiling
scheme).  Peak memory is one strip's tail instead of the whole image's.
APPROXIMATE: each strip's GroupNorms take their own statistics.

The sharded decodes across devices (`sharded_decode`,
`sharded_decode_exact`) are ROADMAP.md queue A item 16.
"""

from __future__ import annotations

import torch


def _tile_weights(idx: int, num_tiles: int, tile_w: int, overlap: int,
                  device=None) -> torch.Tensor:
    """(tile_w,) fp32 cross-fade weights: linear ramps over the overlap at
    interior edges, 1 in the core and at the image's own edges."""
    pos = torch.arange(tile_w, dtype=torch.float32, device=device)
    w = torch.ones(tile_w, dtype=torch.float32, device=device)
    if idx > 0:
        w = torch.minimum(w, ((pos + 1.0) / (overlap + 1.0)).clamp(0.0, 1.0))
    if idx < num_tiles - 1:
        w = torch.minimum(w, ((tile_w - pos) / (overlap + 1.0)).clamp(0.0, 1.0))
    return w


def tiled_decode(vae, z: torch.Tensor, num_tiles: int = 4, overlap: int = 8,
                 scale: int = 8) -> torch.Tensor:
    """(B, latent C, h, w) scaled latents -> (B, out C, h·scale, w·scale):
    the head once, the tail over `num_tiles` overlapping width strips in
    turn, blended."""
    h = vae.decoder.head(vae.post_quant_conv(z))
    b, _, hl, wl = h.shape
    chunk = wl // num_tiles
    tile_lat = chunk + 2 * overlap
    if wl % num_tiles or wl < tile_lat:
        raise ValueError(f"latent width {wl} does not split into {num_tiles} tiles "
                         f"with overlap {overlap}")
    canvas = torch.zeros(b, vae.out_channels, hl * scale, wl * scale, dtype=h.dtype,
                         device=h.device)
    wsum = torch.zeros(wl * scale, dtype=torch.float32, device=h.device)
    for idx in range(num_tiles):
        start = min(max(idx * chunk - overlap, 0), wl - tile_lat)
        out = vae.decoder.tail(h[..., start:start + tile_lat])
        wts = _tile_weights(idx, num_tiles, tile_lat * scale, 2 * overlap * scale, h.device)
        cols = slice(start * scale, (start + tile_lat) * scale)
        canvas[..., cols] += out * wts.to(out.dtype)
        wsum[cols] += wts
    return canvas / wsum.clamp(min=1e-8).to(canvas.dtype)
