"""Tiled and sharded VAE decodes (counterpart of
`reflecting_reality_tpu/parallel/sharded_vae.py`).

The decoder splits into a head (post_quant_conv -> conv_in -> mid block,
where the global attention lives; run whole, once) and a tail (conv-only up
blocks, GroupNorm+SiLU, conv_out; a finite receptive field).  Three decodes
split the tail along the latent width:

- `tiled_decode` (one device): `num_tiles` overlapping strips in turn, each
  widened by `overlap` latent columns on either side, cross-faded with
  linear ramps over their overlaps (the diffusers enable_vae_tiling
  scheme).  Peak memory is one strip's tail instead of the whole image's.
  APPROXIMATE: each strip's GroupNorms take their own statistics.
- `sharded_decode` (a mesh, `parallel.mesh.make_mesh`): one overlapping
  strip per mesh entry, each on its entry's device, the weighted strips
  summed onto the first device's canvas (JAX's psum of the weighted
  canvases).  The same arithmetic as `tiled_decode` with one tile an entry.
- `sharded_decode_exact` (a mesh): the tail W-sharded with EXACT
  statistics: every GroupNorm sums each shard's per-group sums on the first
  device and sends the (B, G) statistics back (fp32, two-pass: the mean,
  then the mean squared deviation, the arithmetic of `ops.norms`), and every
  3x3 conv takes one halo column from each neighbouring shard (zeros at the
  image's edges, the conv's own zero padding).  Nearest x2 upsampling maps
  output columns 2k, 2k+1 to input column k, so the shards need no
  redistribution.  Matches the unsharded decode to fp32 reassociation.

In JAX the mesh runs the shards as one `shard_map` program; here one
process runs them in turn on their devices, the copies between devices
standing in for `psum` and `ppermute`.  The psum GroupNorm is plain
arithmetic in JAX (no Pallas), so it is plain PyTorch here; the head's
GroupNorms take kernel B2 on the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reflecting_reality_tpu_torch.parallel.mesh import Mesh, replicated


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


def _head(vae, z: torch.Tensor) -> torch.Tensor:
    return vae.decoder.head(vae.post_quant_conv(z))


def _blend(vae, h: torch.Tensor, num_tiles: int, overlap: int, scale: int,
           tail_of: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The head's output `h` -> the image: strip `idx`'s tail by
    `tail_of(idx, strip)`, weighted onto one canvas on h's device."""
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
        out = tail_of(idx, h[..., start:start + tile_lat])
        wts = _tile_weights(idx, num_tiles, tile_lat * scale, 2 * overlap * scale, out.device)
        cols = slice(start * scale, (start + tile_lat) * scale)
        canvas[..., cols] += (out * wts.to(out.dtype)).to(h.device)
        wsum[cols] += wts.to(h.device)
    return canvas / wsum.clamp(min=1e-8).to(canvas.dtype)


def tiled_decode(vae, z: torch.Tensor, num_tiles: int = 4, overlap: int = 8,
                 scale: int = 8) -> torch.Tensor:
    """(B, latent C, h, w) scaled latents -> (B, out C, h·scale, w·scale):
    the head once, the tail over `num_tiles` overlapping width strips in
    turn, blended."""
    return _blend(vae, _head(vae, z), num_tiles, overlap, scale,
                  lambda idx, strip: vae.decoder.tail(strip))


def sharded_decode(vae, z: torch.Tensor, mesh: Mesh, overlap: int = 8, scale: int = 8,
                   replicas: Optional[Sequence] = None) -> torch.Tensor:
    """`tiled_decode` with one strip per mesh entry, each entry's tail on
    its device (`replicas[i]`, a VAE there; default `replicated(vae,
    mesh)`), the weighted strips summed on z's device."""
    replicas = list(replicas) if replicas is not None else replicated(vae, mesh)
    return _blend(vae, _head(vae, z), len(mesh), overlap, scale,
                  lambda idx, strip: replicas[idx].decoder.tail(strip.to(mesh[idx])))


# --------------------------------------------------------------------- exact

def _psum(parts: List[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors on the first shard's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _psum_group_norm(xs: List[torch.Tensor], norms, apply_silu: bool = True
                     ) -> List[torch.Tensor]:
    """GroupNorm over W shards with the global statistics: fp32, two-pass
    (mean, then the mean squared deviation), summed across the shards;
    `norms[i]` is shard i's `ops.norms.GroupNorm` replica."""
    b, c = xs[0].shape[:2]
    g, eps = norms[0].num_groups, norms[0].eps
    count = float(sum(x[0, 0].numel() for x in xs) * (c // g))
    xg = [x.reshape(b, g, -1).float() for x in xs]
    mean = _psum([x.sum(-1) for x in xg]) / count                       # (B, G)
    dev = [x - mean.to(x.device)[..., None] for x in xg]
    var = _psum([(d * d).sum(-1) for d in dev]) / count
    out = []
    for x, d, norm in zip(xs, dev, norms):
        y = (d * torch.rsqrt(var.to(x.device)[..., None] + eps)).reshape(x.shape)
        y = y * norm.weight.float()[:, None, None] + norm.bias.float()[:, None, None]
        if apply_silu:
            y = F.silu(y)
        out.append(y.to(x.dtype))
    return out


def _halo_conv3(xs: List[torch.Tensor], convs) -> List[torch.Tensor]:
    """A 3x3 stride-1 conv over W shards: each shard takes its neighbours'
    edge columns (zeros at the image's edges) and convolves without padding
    in W.  `convs[i]` is shard i's `nn.Conv2d` replica."""
    out = []
    for i, (x, conv) in enumerate(zip(xs, convs)):
        zeros = torch.zeros_like(x[..., :1])
        left = xs[i - 1][..., -1:].to(x.device) if i > 0 else zeros
        right = xs[i + 1][..., :1].to(x.device) if i + 1 < len(xs) else zeros
        out.append(F.conv2d(torch.cat([left, x, right], dim=-1), conv.weight, conv.bias,
                            padding=(1, 0)))
    return out


def _sharded_resnet(xs: List[torch.Tensor], resnets) -> List[torch.Tensor]:
    """`ops.resnet.ResnetBlock2D` (no temb) over W shards."""
    h = _psum_group_norm(xs, [r.norm1 for r in resnets])
    h = _halo_conv3(h, [r.conv1 for r in resnets])
    h = _psum_group_norm(h, [r.norm2 for r in resnets])
    h = _halo_conv3(h, [r.conv2 for r in resnets])
    if resnets[0].conv_shortcut is not None:
        xs = [r.conv_shortcut(x) for x, r in zip(xs, resnets)]
    return [x + y for x, y in zip(xs, h)]


def sharded_decode_exact(vae, z: torch.Tensor, mesh: Mesh,
                         replicas: Optional[Sequence] = None) -> torch.Tensor:
    """EXACT mesh decode: the head once on z's device, the tail W-sharded
    over the mesh (one shard of h / n columns an entry, on its device) with
    psum GroupNorm statistics and a halo exchange at every 3x3 conv; the
    shards gathered on z's device.  `replicas[i]` is a VAE on entry i's
    device (default `replicated(vae, mesh)`)."""
    replicas = list(replicas) if replicas is not None else replicated(vae, mesh)
    n = len(mesh)
    h = _head(vae, z)
    if h.shape[-1] % n:
        raise ValueError(f"latent width {h.shape[-1]} is not divisible by the mesh size ({n})")
    xs = [part.to(d) for part, d in zip(h.chunk(n, dim=-1), mesh)]
    decs = [r.decoder for r in replicas]
    for i, block in enumerate(decs[0].up_blocks):
        for j in range(len(block.resnets)):
            xs = _sharded_resnet(xs, [d.up_blocks[i].resnets[j] for d in decs])
        if block.upsamplers is not None:
            # nearest x2 keeps every output column on its input's shard
            xs = [F.interpolate(x, scale_factor=2.0, mode="nearest") for x in xs]
            xs = _halo_conv3(xs, [d.up_blocks[i].upsamplers[0].conv for d in decs])
    xs = _psum_group_norm(xs, [d.conv_norm_out for d in decs])
    xs = _halo_conv3(xs, [d.conv_out for d in decs])
    return torch.cat([x.to(z.device) for x in xs], dim=-1)
