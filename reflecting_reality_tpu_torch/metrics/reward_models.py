"""Image_Reward / HPS_V2.1 scorer hooks, the port's copy of
`reflecting_reality_tpu/metrics/reward_models.py` (reference:
metrics/metrics.py: Image_Reward via `ImageReward.load("ImageReward-v1.0")`
:104-106,167-169 and HPS via `hpsv2.score(..., hps_version="v2.1")`
:171-174).

These are whole external reward models.  As in JAX they stay optional: the
hooks import their packages lazily and raise an actionable error only when
the metric is requested.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _to_pil(image):
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def build_image_reward(ckpt_path: str = "data/ckpt") -> Callable:
    """ImageReward-v1.0 scorer (reference metrics.py:104-106,167-169)."""
    try:
        import ImageReward as RM
    except ImportError as e:
        raise RuntimeError(
            "Image_Reward needs the `image-reward` package; install "
            "it or pass a scorer via extra_scorers={'Image_Reward': fn}"
        ) from e

    model = RM.load("ImageReward-v1.0", download_root=ckpt_path)

    def score(image, caption: str) -> float:
        return float(model.score(caption, _to_pil(image)))

    return score


def build_hps(hps_version: str = "v2.1") -> Callable:
    """HPSv2 scorer (reference metrics.py:171-174)."""
    try:
        import hpsv2
    except ImportError as e:
        raise RuntimeError(
            "HPS_V2.1 needs the `hpsv2` package; install it or pass "
            "a scorer via extra_scorers={'HPS_V2.1': fn}"
        ) from e

    def score(image, caption: str) -> float:
        return float(hpsv2.score(_to_pil(image), caption, hps_version=hps_version)[0])

    return score


def build_reward_scorers(metrics_to_compute, ckpt_path: str = "data/ckpt") -> Dict[str, Callable]:
    """Hooks for whichever reward metrics are requested; each is built on
    its own, so one missing package does not block the others."""
    out: Dict[str, Callable] = {}
    if any("Image_Reward" in m for m in metrics_to_compute):
        out["Image_Reward"] = build_image_reward(ckpt_path)
    if any("HPS_V2.1" in m for m in metrics_to_compute):
        out["HPS_V2.1"] = build_hps()
    return out
