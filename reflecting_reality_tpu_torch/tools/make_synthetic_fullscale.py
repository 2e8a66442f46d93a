"""Synthetic full-scale run fixture: an SD-1.5-shaped checkpoint and a
SynMirror shard (the port's copy of
`reflecting_reality_tpu/tools/make_synthetic_fullscale.py`).

The reference's primary artifact is a 20K-step training job on SynMirror
(train_brushnet_mirror.py:1346-1523, recipe MirrorFusion/README.md).
Without the dataset or the trained weights, the proxy is: weights drawn from
a seed at the exact SD-1.5 shapes, written in the reference checkpoint
layout by the port's `core.io.save_pretrained`, plus a synthetic SynMirror
HDF5 shard at full 512x512 resolution, for `cli/train.py`, a resume from
its checkpoint and `cli/test.py`.

Images are LOW-FREQUENCY random fields (16x16 bilinear-upsampled), not white
noise: their VAE latents carry structure the brushnet can learn to exploit,
and PSNR against them is meaningful for the eval protocol.

Usage:
  python -m reflecting_reality_tpu_torch.tools.make_synthetic_fullscale \
      --out /tmp/rr_e2e [--n 64] [--size 512] [--tiny] [--device cuda]
Writes:
  <out>/sd15/{unet,vae,text_encoder,tokenizer}/   reference-layout checkpoint
  <out>/data/obj/*.hdf5 + train.csv + test.csv    SynMirror-layout shard
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# A valid byte-level CLIP vocab with no merges (ids stay < 49408, so the
# full-size text encoders' embedding tables cover them): the tokenizer of
# every checkpoint drawn from a seed, SDXL's included.
from reflecting_reality_tpu_torch.data.tokenizer import write_byte_vocab as write_byte_tokenizer


def make_checkpoint(base_dir: str, seed: int = 0, tiny: bool = False,
                    device: str = "cuda") -> str:
    """SD-1.5-shaped components drawn from `seed` on `device`, in the
    reference folder layout (what `from_pretrained` reads back: unet/ vae/
    text_encoder/ tokenizer/)."""
    import torch

    from reflecting_reality_tpu_torch.core.device import resolve_device
    from reflecting_reality_tpu_torch.core.io import save_pretrained, save_safetensors
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    dev = resolve_device(device)
    if tiny:
        unet_cfg = dict(sample_size=8, block_out_channels=(8, 16, 16, 16),
                        attention_head_dim=2, cross_attention_dim=32,
                        norm_num_groups=4, layers_per_block=2)
        vae_cfg = dict(block_out_channels=(4, 4, 4, 4), norm_num_groups=2)
        text_cfg = dict(vocab_size=49408, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=77)
    else:
        unet_cfg, vae_cfg, text_cfg = {}, {}, {}    # SD-1.5 / CLIP ViT-L/14 defaults

    torch.manual_seed(seed)
    for sub, cls, cfg in (("unet", UNet2DConditionModel, unet_cfg),
                          ("vae", AutoencoderKL, vae_cfg)):
        with torch.device(dev):
            module = cls(**cfg)
        save_pretrained(module, os.path.join(base_dir, sub))
        del module
    with torch.device(dev):
        text = CLIPTextModel(**text_cfg)
    tdir = os.path.join(base_dir, "text_encoder")
    text.save_config(tdir)
    save_safetensors(text.state_dict(), os.path.join(tdir, "model.safetensors"))
    write_byte_tokenizer(os.path.join(base_dir, "tokenizer"))
    return base_dir


def _lowfreq(rng: np.random.RandomState, size: int, ch: int) -> np.ndarray:
    """(size, size, ch) in [0, 1): 16x16 random field, bilinear-upsampled —
    structured enough for VAE latents to be learnable."""
    from PIL import Image

    coarse = rng.rand(16, 16, ch).astype(np.float32)
    planes = [np.asarray(Image.fromarray(
        (coarse[..., c] * 255).astype(np.uint8)).resize((size, size),
                                                        Image.BILINEAR))
              for c in range(ch)]
    return np.stack(planes, axis=-1).astype(np.float32) / 255.0


def make_data(data_dir: str, n: int = 64, size: int = 512) -> None:
    """SynMirror-layout shard: obj/*.hdf5 (colors, category_id_segmaps with
    1=mirror 2=object, depth, normals, cam_states) + train.csv/test.csv —
    the exact keys extract_data_from_hdf5 reads (reference
    data_utils.get_hdf5_data)."""
    import h5py
    import pandas as pd

    rows = []
    os.makedirs(os.path.join(data_dir, "obj"), exist_ok=True)
    q = size // 4
    for i in range(n):
        rng = np.random.RandomState(1000 + i)
        seg = np.zeros((size, size), np.uint8)
        seg[q: 3 * q, q: 3 * q] = 1                        # mirror plane
        oy, ox = rng.randint(q + 8, 2 * q, 2)
        seg[oy: oy + q // 2, ox: ox + q // 2] = 2          # object in mirror
        colors = (_lowfreq(rng, size, 3) * 255).astype(np.uint8)
        depth = (2.0 + 3.0 * _lowfreq(rng, size, 1)[..., 0]).astype(np.float32)
        nrm = _lowfreq(rng, size, 3) - 0.5
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-6
        cam = json.dumps({"cam2world": np.eye(4).tolist(),
                          "cam_K": np.eye(3).tolist()}).encode()
        with h5py.File(os.path.join(data_dir, f"obj/{i}.hdf5"), "w") as f:
            f["colors"] = colors
            f["category_id_segmaps"] = seg
            f["depth"] = depth
            f["normals"] = nrm.astype(np.float32)
            f["cam_states"] = np.frombuffer(cam, dtype=np.uint8)
        rows.append({"uid": f"uid{i:03d}", "path": f"obj/{i}.hdf5",
                     "auto_caption": f"a low frequency scene number {i}"})
    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(data_dir, "train.csv"), index=False)
    df.iloc[: max(4, n // 8)].to_csv(os.path.join(data_dir, "test.csv"),
                                     index=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny-config checkpoint (CI-sized) instead of SD-1.5")
    ap.add_argument("--skip_checkpoint", action="store_true")
    ap.add_argument("--skip_data", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the weights are drawn (default: the card)")
    args = ap.parse_args(argv)

    if not args.skip_checkpoint:
        make_checkpoint(os.path.join(args.out, "sd15"), args.seed, args.tiny, args.device)
        print(f"checkpoint: {os.path.join(args.out, 'sd15')}", flush=True)
    if not args.skip_data:
        make_data(os.path.join(args.out, "data"), args.n, args.size)
        print(f"data: {os.path.join(args.out, 'data')} ({args.n} samples)", flush=True)


if __name__ == "__main__":
    main()
