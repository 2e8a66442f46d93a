"""SAM-based reflection segmentation, the port's copy of the numpy half of
`reflecting_reality_tpu/metrics/segmentation.py` (reference:
metrics/segment_reflection.py and metrics/object_metrics.py, with cv2
replaced by numpy/PIL).

The SAM predictor stays an optional host-side dependency, as in the
reference (`segment_anything` and a vit_h checkpoint).  Everything around
it is here: the camera-pose-keyed prompt-point lookup, the bboxes, the
floor-mask OR, the mirror-mask AND and the sam_cache.

One difference from the JAX module: where the SAM checkpoint is not in
`checkpoint_folder`, `SegmentPoints` raises FileNotFoundError naming the
path, where JAX downloads it (:51-55).  The port fetches nothing from a
network; put the checkpoint there first.

Dataset assets (`cam_pose_map.json`, `floor_masks/*.png`) are looked up
under `data_dir/metrics/` first, then `data_dir/`; they ship with
SynMirror's eval kit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


class EmptyObjectMaskError(ValueError):
    """Raised when a GT sample's segmap has no object pixels (class 2):
    there is no reflection to segment, so obj_*/IoU cells become NaN."""


_SAM_FILES = {
    "vit_b": "sam_vit_b_01ec64.pth",
    "vit_l": "sam_vit_l_0b3195.pth",
    "vit_h": "sam_vit_h_4b8939.pth",
}


class SegmentPoints:
    """Wraps segment_anything's SamPredictor (reference segment_reflection.py:12)."""

    def __init__(self, checkpoint_folder: str, version: str = "vit_h", device: str = "cpu"):
        try:
            from segment_anything import SamPredictor, sam_model_registry
        except ImportError as e:
            raise ImportError(
                "obj_*/IoU metrics need the optional `segment_anything` package"
            ) from e
        name = next(v for v in _SAM_FILES if v in version)
        ckpt = os.path.join(checkpoint_folder, _SAM_FILES[name])
        if not os.path.exists(ckpt):
            raise FileNotFoundError(
                f"SAM {name} checkpoint not found at {ckpt} (the port downloads nothing)")
        self.predictor = SamPredictor(sam_model_registry[name](checkpoint=ckpt))

    def set_image(self, image: np.ndarray) -> None:
        self.predictor.set_image(np.asarray(image))

    def give_mask(self, bbox) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.predictor.predict(box=np.array([bbox]), multimask_output=True)


def load_cam_pose_map(data_dir: str) -> Dict:
    for p in (
        os.path.join(data_dir, "metrics", "cam_pose_map.json"),
        os.path.join(data_dir, "cam_pose_map.json"),
    ):
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    raise FileNotFoundError(
        f"cam_pose_map.json not found under {data_dir} (ships with SynMirror's eval kit)"
    )


def create_sign_vector(vector: np.ndarray) -> np.ndarray:
    return np.where(vector != 0, np.sign(vector), 1).astype(int)


def get_point_from_cam_states(gt_data: Dict, cam_pose_map: Dict):
    """Signed-norm camera key -> (prompt point, bbox ratios, floor-mask name)
    (reference object_metrics.py:18-52, incl. nearest-key fallback)."""
    cam_states = np.asarray(gt_data["cam_states"])
    cam2world = json.loads(cam_states.tobytes().decode("utf-8"))["cam2world"]
    t = np.array(cam2world)[:3, 3]
    s = create_sign_vector(t)
    key = round(float(np.linalg.norm(t)) * s[0] * s[1] * s[2], 3)

    entry = cam_pose_map.get(str(key))
    if entry is None:
        try:
            values = [float(k) for k in cam_pose_map]
            nearest = min(values, key=lambda x: abs(x - key))
            entry = cam_pose_map[str(nearest)]
        except (ValueError, KeyError):
            return [80, 250], 0.9, 0.9, "0.png"
    if isinstance(entry, list):
        entry = entry[0]
    return entry["point"], entry["ratio_w"], entry["ratio_h"], entry["floor_path"]


def get_bbox_from_mask(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)


def create_bbox_from_point(point, width: int, height: int):
    width, height = max(width, 50), max(height, 50)
    x, y = point
    return (max(0, x - width // 2), max(0, y - height // 2), x + width // 2, y + height // 2)


def _apply_mask(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    m = (np.asarray(mask) > 0)
    out = np.array(img)
    out[~m] = 0
    return out


def _read_gray(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def get_sam_mask(segmenter: SegmentPoints, image: np.ndarray, bbox) -> np.ndarray:
    segmenter.set_image(image)
    masks, _scores, _logits = segmenter.give_mask(bbox)
    best = masks[int(np.argmax([m.sum() for m in masks]))]
    return (best * 255).astype(np.uint8)


def segment_image(
    gt_data: Dict,
    gen_image: np.ndarray,
    segmenter: SegmentPoints,
    cam_pose_map: Dict,
    gt_sam_cache: str = "",
    save_cache: bool = True,
    use_floor_mask: bool = False,
    use_gt_mask: bool = False,
    data_dir: str = ".",
):
    """reference object_metrics.py:86-156 -> (sam_mask_gt, masked_img_gt,
    sam_mask_gen, masked_img_gen)."""
    point, ratio_w, ratio_h, floor_path = get_point_from_cam_states(gt_data, cam_pose_map)
    mirror_mask = gt_data["mask"]
    floor_mask = np.zeros_like(mirror_mask)
    if use_floor_mask:
        for base in (os.path.join(data_dir, "metrics", "floor_masks"),
                     os.path.join(data_dir, "floor_masks")):
            p = os.path.join(base, floor_path)
            if os.path.exists(p):
                floor_mask = _read_gray(p)
                break

    gt_img, object_mask = gt_data["image"], gt_data["object_mask"]
    gt_masked = _apply_mask(gt_img, mirror_mask)
    gen_masked = _apply_mask(gen_image, mirror_mask)

    obj_bbox = get_bbox_from_mask(object_mask)
    if obj_bbox is None:
        raise EmptyObjectMaskError(
            "sample has no object pixels (segmap class 2); obj_*/IoU undefined"
        )
    x1, y1, x2, y2 = obj_bbox
    bbox = create_bbox_from_point(point, int((x2 - x1) * ratio_w), int((y2 - y1) * ratio_h))

    if gt_sam_cache and os.path.exists(gt_sam_cache):
        sam_mask_gt = _read_gray(gt_sam_cache)
    else:
        sam_mask_gt = get_sam_mask(segmenter, gt_masked, bbox)
        if save_cache and gt_sam_cache:
            from PIL import Image

            os.makedirs(os.path.dirname(gt_sam_cache), exist_ok=True)
            Image.fromarray(sam_mask_gt).save(gt_sam_cache)

    combined_gt = np.logical_and(np.logical_or(floor_mask > 0, sam_mask_gt > 0), mirror_mask > 0)
    masked_img_gt = _apply_mask(gt_img, combined_gt)

    sam_mask_gen = sam_mask_gt if use_gt_mask else get_sam_mask(segmenter, gen_masked, bbox)
    combined_gen = np.logical_and(np.logical_or(floor_mask > 0, sam_mask_gen > 0), mirror_mask > 0)
    masked_img_gen = _apply_mask(gen_image, combined_gen)

    return sam_mask_gt, masked_img_gt, sam_mask_gen, masked_img_gen
