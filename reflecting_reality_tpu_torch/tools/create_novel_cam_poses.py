"""Generate cam_pose_map.json for the SAM reflection-segmentation prompts,
the port's copy of `reflecting_reality_tpu/tools/create_novel_cam_poses.py`
(reference: metrics/create_novel_cam_poses.py).

Each of the 19 novel camera views maps its signed cam2world-translation norm
(the lookup key metrics.segmentation.get_point_from_cam_states uses) to a SAM
prompt point, bbox scale ratios, and the floor-mask file for that pose.

Usage:
    python -m reflecting_reality_tpu_torch.tools.create_novel_cam_poses \
        --novel_views_dir data/novel_views/R/B07B4D499R --out cam_pose_map.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from reflecting_reality_tpu_torch.metrics.segmentation import create_sign_vector

# The reference's hand-picked prompt points for the 19 canonical poses
# (metrics/create_novel_cam_poses.py point_list).
DEFAULT_POINTS = [
    (95, 180), (410, 180), (240, 80), (120, 170), (140, 160), (150, 150),
    (170, 140), (180, 130), (200, 120), (210, 110), (220, 110), (390, 170),
    (380, 160), (350, 150), (350, 150), (340, 140), (320, 120), (300, 110),
    (290, 100),
]


def cam2world_key(hdf5_path: str) -> float:
    import h5py

    with h5py.File(hdf5_path, "r") as f:
        cam_states = np.array(f["cam_states"])
    cam2world = json.loads(cam_states.tobytes().decode("utf-8"))["cam2world"]
    t = np.array(cam2world)[:3, 3]
    s = create_sign_vector(t)
    return round(float(np.linalg.norm(t)) * s[0] * s[1] * s[2], 3)


def build_map(novel_views_dir: str, points=DEFAULT_POINTS,
              ratio_w: float = 0.7, ratio_h: float = 0.7) -> dict:
    out = {}
    for i, point in enumerate(points):
        path = os.path.join(novel_views_dir, f"{i}.hdf5")
        key = cam2world_key(path)
        out[str(key)] = {"point": list(point), "ratio_w": ratio_w,
                         "ratio_h": ratio_h, "floor_path": f"{i}.png"}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Build cam_pose_map.json")
    p.add_argument("--novel_views_dir", type=str, required=True)
    p.add_argument("--out", type=str, default="cam_pose_map.json")
    p.add_argument("--ratio_w", type=float, default=0.7)
    p.add_argument("--ratio_h", type=float, default=0.7)
    args = p.parse_args(argv)
    m = build_map(args.novel_views_dir, ratio_w=args.ratio_w, ratio_h=args.ratio_h)
    with open(args.out, "w") as f:
        json.dump(m, f, indent=4)
    print(f"wrote {args.out} ({len(m)} poses)")


if __name__ == "__main__":
    main()
