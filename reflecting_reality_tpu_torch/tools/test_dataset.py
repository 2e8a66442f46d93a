"""SynMirror corruption scanner, the port's copy of
`reflecting_reality_tpu/tools/test_dataset.py` (reference:
examples/brushnet/scripts/test_dataset.py).

Checks every .hdf5 under --data_dir for:
1. null rgb/mask/depth/normals datasets
2. all-black rgb
3. mask without a mirror region
4. object mask below --obj_pixels_threshold pixels
5. constant depth map
6. constant normals map

Corrupt uids are written to --report (one per line); optional --output_dir
saves png renders of the corrupt samples for inspection.  Parallel over a
thread pool (h5py releases the GIL; the reference used a process Pool).

Usage:
  python -m reflecting_reality_tpu_torch.tools.test_dataset --data_dir <dir> \
    [--report corrupt_uids.txt] [--output_dir renders/]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None
try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def convert_to_uint8(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.float64)
    if data.max() > 1:
        data = data / 255.0
    return (np.clip(data, 0, 1) * 255).astype(np.uint8)


def check_sample(hdf5_path: str, obj_pixels_threshold: int = 10) -> Optional[str]:
    """Return a failure reason for one file, or None if clean."""
    with h5py.File(hdf5_path, "r") as f:
        for key in ("colors", "category_id_segmaps", "depth", "normals"):
            if key not in f or f[key].shape is None:
                return f"Null data: missing {key}"
        rgb = np.array(f["colors"])
        seg = np.array(f["category_id_segmaps"])
        depth = np.array(f["depth"])
        normals = np.array(f["normals"])

    if rgb.size == 0 or not np.isfinite(rgb).all():
        return "Null data: rgb"
    if rgb.max() == 0:
        return "Black image"
    if not (seg == 1).any():
        return "Mask has no mirror"
    if (seg == 2).sum() < obj_pixels_threshold:
        return f"Object mask below {obj_pixels_threshold} pixels"
    if not np.isfinite(depth).all() or depth.max() == depth.min():
        return "Constant or invalid depth"
    if not np.isfinite(normals).all() or normals.max() == normals.min():
        return "Constant or invalid normals"
    return None


def _save_debug(hdf5_path: str, output_path: str) -> None:
    with h5py.File(hdf5_path, "r") as f:
        panels = []
        if "colors" in f:
            panels.append(np.array(f["colors"]))
        if "category_id_segmaps" in f:
            seg = np.array(f["category_id_segmaps"])
            panels.append(np.stack([convert_to_uint8(seg == i) for i in (1, 2, 0)], -1))
        if "depth" in f:
            d = np.array(f["depth"])
            rng = d.max() - d.min()
            d8 = convert_to_uint8((d - d.min()) / rng if rng > 0 else d * 0)
            panels.append(np.stack([d8] * 3, -1))
    h = min(p.shape[0] for p in panels)
    strip = np.concatenate([p[:h] for p in panels], axis=1)
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    Image.fromarray(strip.astype(np.uint8)).save(output_path)


def scan(data_dir: str, obj_pixels_threshold: int = 10, processes: int = 8,
         output_dir: Optional[str] = None,
         ignore_dirs: Tuple[str, ...] = ()) -> List[Tuple[str, str]]:
    files = []
    for root, dirs, names in os.walk(data_dir):
        dirs[:] = [d for d in dirs if d not in ignore_dirs]
        files += [os.path.join(root, n) for n in names if n.endswith(".hdf5")]
    files.sort()

    def work(path):
        try:
            reason = check_sample(path, obj_pixels_threshold)
        except Exception as e:
            reason = f"{type(e).__name__}: {e}"
        if reason and output_dir and "Null" not in reason:
            rel = os.path.relpath(path, data_dir).replace(".hdf5", ".png")
            try:
                _save_debug(path, os.path.join(output_dir, rel))
            except Exception:
                pass
        return (os.path.relpath(path, data_dir), reason)

    with ThreadPoolExecutor(max(processes, 1)) as pool:
        results = list(pool.map(work, files))
    return [(p, r) for p, r in results if r]


def main(argv=None):
    p = argparse.ArgumentParser(description="Check HDF5 files for corrupt data")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--report", type=str, default="corrupt_uids.txt")
    p.add_argument("--obj_pixels_threshold", type=int, default=10)
    p.add_argument("--processes", type=int, default=8)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--ignore_dirs", type=str, nargs="+", default=[])
    args = p.parse_args(argv)

    corrupt = scan(args.data_dir, args.obj_pixels_threshold, args.processes,
                   args.output_dir, tuple(args.ignore_dirs))
    with open(args.report, "w") as f:
        for path, reason in corrupt:
            f.write(f"{path}\t{reason}\n")
    print(f"{len(corrupt)} corrupt samples; report -> {args.report}")


if __name__ == "__main__":
    main()
