"""MetricsCalculator, the port's counterpart of
`reflecting_reality_tpu/metrics/calculator.py` (reference:
metrics/metrics.py:70-209).

Metric families and crops, as in the reference:
- full  PSNR/SSIM/LPIPS: the whole image.
- mask_*: preservation: gt = masked_image (mirror zeroed), gen = gen with
  the GT mirror region zeroed (metrics.py:139-141).
- mirror_*: inside the mirror only: both images zeroed OUTSIDE the mask
  (metrics.py:143-145).
- obj_* / IoU: the SAM-segmented reflection region (metrics.py:111-137);
  needs the optional `segment_anything` package and the dataset's assets,
  built only when those metrics are requested.
- CLIP_Similarity / Aesthetic_Score / Image_Reward / HPS_V2.1: external
  scorer models through the `extra_scorers` hook or the reward hooks; they
  raise only when requested.

PSNR/SSIM run through `metrics/functional.py` and LPIPS through the port's
SqueezeNet module, all on the calculator's `device` (default the card;
device="cpu" runs them on the CPU).  SSIM's filter and LPIPS's convolutions
run in full fp32 (TF32 off), so a score does not depend on the device
beyond summation order.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import fp32_convolutions, resolve_device
from reflecting_reality_tpu_torch.data.synmirror import get_masked_image
from reflecting_reality_tpu_torch.metrics.functional import iou as iou_fn
from reflecting_reality_tpu_torch.metrics.functional import psnr as psnr_fn
from reflecting_reality_tpu_torch.metrics.functional import ssim as ssim_fn


def normalize_pair(image: np.ndarray, norm_range=(-1, 1)):
    """(normalized, original) like metrics.py:get_normalised_tensor: the
    original 0-255 floats feed PSNR/SSIM, the normalized copy feeds LPIPS."""
    original = np.asarray(image, np.float32)
    if list(norm_range) == [-1, 1]:
        normalized = original / 127.5 - 1.0
    elif list(norm_range) == [0, 1]:
        normalized = original / 255.0
    else:
        raise ValueError(norm_range)
    return normalized, original


class MetricsCalculator:
    def __init__(
        self,
        metrics_to_compute,
        data_dir: str = ".",
        cache_dir: str = "sam_cache",
        ckpt_path: str = "data/ckpt",
        norm_range=(-1, 1),
        lpips_weights: Optional[str] = None,
        extra_scorers: Optional[Dict[str, Callable]] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.metrics_to_compute = list(metrics_to_compute)
        self.norm_range = norm_range
        self.data_dir = data_dir
        self.cache_dir = cache_dir
        self.ckpt_path = ckpt_path
        self.extra_scorers = extra_scorers or {}
        self._lpips = None
        self._lpips_weights = lpips_weights
        self._segmenter = None
        self._cam_pose_map = None

        needs_sam = any(("obj" in m) or ("IoU" in m) for m in self.metrics_to_compute)
        if needs_sam:
            from reflecting_reality_tpu_torch.metrics.segmentation import (
                SegmentPoints, load_cam_pose_map,
            )

            self._segmenter = SegmentPoints(version="vit_h", checkpoint_folder=ckpt_path,
                                            device=self.device)
            self._cam_pose_map = load_cam_pose_map(data_dir)

    # ------------------------------------------------------------- primitives

    def calculate_psnr(self, pred, gt) -> float:
        return float(psnr_fn(pred, gt, device=self.device))

    def calculate_ssim(self, pred, gt) -> float:
        with fp32_convolutions():
            return float(ssim_fn(pred, gt, device=self.device))

    def lpips_module(self):
        """The LPIPS module on the calculator's device, loaded on first use
        from `lpips_weights`: the JAX package's .npz, or a torch
        lpips-squeeze checkpoint."""
        if self._lpips is None:
            from reflecting_reality_tpu_torch.core.io import load_into
            from reflecting_reality_tpu_torch.metrics.lpips import (
                LPIPS, load_lpips_npz, load_torch_lpips_state,
            )

            if self._lpips_weights is None:
                raise RuntimeError(
                    "LPIPS requested but no weights file given (pass "
                    "lpips_weights=<.npz from tools/convert_lpips.py, or a "
                    "torch lpips-squeeze checkpoint>)"
                )
            if str(self._lpips_weights).endswith(".npz"):
                state = load_lpips_npz(self._lpips_weights)
            else:
                state = load_torch_lpips_state(
                    {k: v.numpy() for k, v in
                     torch.load(self._lpips_weights, map_location="cpu").items()})
            self._lpips = load_into(LPIPS(), state, where=str(self._lpips_weights)) \
                .to(self.device).eval()
        return self._lpips

    def calculate_lpips(self, pred, gt) -> float:
        """NHWC or HWC floats in [-1, 1] -> LPIPS."""
        module = self.lpips_module()

        def nchw(x):
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return (x[None] if x.dim() == 3 else x).permute(0, 3, 1, 2)

        with torch.inference_mode(), fp32_convolutions():
            return float(module(nchw(pred), nchw(gt)))

    calculate_iou = staticmethod(iou_fn)

    # ---------------------------------------------------------------- dispatch

    def compute_metric(self, metric_name: str, gen_image, gt_data: Dict, caption: str):
        gen_image = np.array(gen_image)
        gt_image = gt_data["image"]

        if "obj" in metric_name or "IoU" in metric_name:
            from reflecting_reality_tpu_torch.metrics.segmentation import (
                EmptyObjectMaskError, segment_image,
            )

            rel_path = gt_data["file_path"].split(".")[0]
            gt_sam_cache = os.path.join(self.data_dir, self.cache_dir, f"{rel_path}.png")
            use_obj = "obj" in metric_name
            try:
                gt_mask, gt_img_seg, gen_mask, gen_img_seg = segment_image(
                    gt_data=gt_data, gen_image=gen_image, segmenter=self._segmenter,
                    cam_pose_map=self._cam_pose_map, gt_sam_cache=gt_sam_cache,
                    use_floor_mask=use_obj, use_gt_mask=use_obj,
                    data_dir=self.data_dir,
                )
            except EmptyObjectMaskError:
                # a NaN cell, not an aborted sample: the eval loop's other
                # metric families stay computable for this uid
                return float("nan")
            if "IoU" in metric_name:
                return self.calculate_iou(gen_mask, gt_mask)
            gt_image, gen_image = gt_img_seg, gen_img_seg
        elif "mask" in metric_name:
            gt_image = gt_data["masked_image"]
            gen_image = get_masked_image(gen_image, gt_data["mask"])
        elif "mirror" in metric_name:
            gt_image = get_masked_image(gt_data["image"], gt_data["mask"], invert=False)
            gen_image = get_masked_image(gen_image, gt_data["mask"], invert=False)

        pred_norm, pred_orig = normalize_pair(gen_image, self.norm_range)
        gt_norm, gt_orig = normalize_pair(gt_image, self.norm_range)

        if "LPIPS" in metric_name:
            return self.calculate_lpips(pred_norm, gt_norm)
        if "PSNR" in metric_name:
            return self.calculate_psnr(pred_orig, gt_orig)
        if "SSIM" in metric_name:
            return self.calculate_ssim(pred_orig, gt_orig)
        if metric_name in self.extra_scorers:
            return self.extra_scorers[metric_name](gen_image, caption)
        if metric_name in ("Image_Reward", "HPS_V2.1"):
            # lazy optional hooks, like SAM (reference loads these models in
            # the MetricsCalculator ctor, metrics.py:86-106)
            from reflecting_reality_tpu_torch.metrics.reward_models import (
                build_hps, build_image_reward,
            )

            if metric_name == "Image_Reward":
                self.extra_scorers[metric_name] = build_image_reward(self.ckpt_path)
            else:
                self.extra_scorers[metric_name] = build_hps()
            return self.extra_scorers[metric_name](gen_image, caption)
        if metric_name in ("CLIP_Similarity", "Aesthetic_Score"):
            raise RuntimeError(
                f"{metric_name} needs an external scorer model; build it with "
                "metrics.scorers.build_extra_scorers(clip_path, aesthetic_head) "
                "or pass extra_scorers={name: fn(image, caption) -> float}"
            )
        raise ValueError(f"Unsupported metric {metric_name}")


def compute_metrics(pred, gt, norm_range=(-1, 1), lpips_weights=None,
                    device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """The trio training validation logs (reference metrics.py:51-67)."""
    calc = MetricsCalculator([], lpips_weights=lpips_weights, device=device)
    pred_n, pred_o = normalize_pair(np.asarray(pred), norm_range)
    gt_n, gt_o = normalize_pair(np.asarray(gt), norm_range)
    out = {
        "ssim": calc.calculate_ssim(pred_o, gt_o),
        "psnr": calc.calculate_psnr(pred_o, gt_o),
    }
    try:
        out["lpips"] = calc.calculate_lpips(pred_n, gt_n)
    except RuntimeError:
        out["lpips"] = float("nan")
    return out
