"""BlenderProc hdf5 extractor/visualizer, the port's copy of
`reflecting_reality_tpu/tools/hdf5extract.py` (reference:
examples/brushnet/scripts/hdf5extract.py).

Dumps each key of SynMirror .hdf5 files to images / json:
- colors           -> <uid>_colors.png
- category_id_segmaps -> <uid>_segmap.png (palette), plus mirror/object masks
- depth            -> <uid>_depth.png (normalized) and optional .npy
- normals          -> <uid>_normals.png
- cam_states       -> <uid>_cam.json

Usage: python -m reflecting_reality_tpu_torch.tools.hdf5extract --input x.hdf5 --output_dir out/
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterable

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None
try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

from reflecting_reality_tpu_torch.data.synmirror import decode_cam_states


def _norm01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    rng = x.max() - x.min()
    return (x - x.min()) / rng if rng > 0 else np.zeros_like(x)


def _save(arr: np.ndarray, path: str) -> None:
    Image.fromarray(arr).save(path)


def extract_file(path: str, output_dir: str, save_npy: bool = False,
                 keys: Iterable[str] = ()) -> list:
    os.makedirs(output_dir, exist_ok=True)
    uid = os.path.splitext(os.path.basename(path))[0]
    written = []

    def out(name):
        p = os.path.join(output_dir, f"{uid}_{name}")
        written.append(p)
        return p

    with h5py.File(path, "r") as f:
        wanted = set(keys) if keys else set(f.keys())
        if "colors" in f and "colors" in wanted:
            _save(np.array(f["colors"], np.uint8), out("colors.png"))
        if "category_id_segmaps" in f and "category_id_segmaps" in wanted:
            seg = np.array(f["category_id_segmaps"], np.uint8)
            palette = np.array(
                [[0, 0, 0], [0, 200, 255], [255, 120, 0]] + [[40 * i % 255] * 3 for i in range(3, 32)],
                np.uint8,
            )
            _save(palette[np.clip(seg, 0, len(palette) - 1)], out("segmap.png"))
            _save(((seg == 1) * 255).astype(np.uint8), out("mirror_mask.png"))
            _save(((seg == 2) * 255).astype(np.uint8), out("object_mask.png"))
        if "depth" in f and "depth" in wanted:
            depth = np.array(f["depth"])
            _save((_norm01(depth) * 255).astype(np.uint8), out("depth.png"))
            if save_npy:
                np.save(out("depth.npy"), depth)
        if "normals" in f and "normals" in wanted:
            normals = np.array(f["normals"])
            _save((_norm01(normals) * 255).astype(np.uint8), out("normals.png"))
        if "cam_states" in f and "cam_states" in wanted:
            cam2world, cam_K = decode_cam_states(np.array(f["cam_states"]))
            with open(out("cam.json"), "w") as jf:
                json.dump({"cam2world": cam2world, "cam_K": cam_K}, jf, indent=2)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="Extract BlenderProc hdf5 contents")
    p.add_argument("--input", type=str, required=True,
                   help=".hdf5 file or a directory of them")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--keys", type=str, nargs="+", default=[])
    p.add_argument("--save_npy", action="store_true")
    args = p.parse_args(argv)

    if os.path.isdir(args.input):
        paths = sorted(
            os.path.join(r, n)
            for r, _, ns in os.walk(args.input)
            for n in ns if n.endswith(".hdf5")
        )
    else:
        paths = [args.input]
    total = 0
    for path in paths:
        total += len(extract_file(path, args.output_dir, args.save_npy, args.keys))
    print(f"wrote {total} files to {args.output_dir}")


if __name__ == "__main__":
    main()
