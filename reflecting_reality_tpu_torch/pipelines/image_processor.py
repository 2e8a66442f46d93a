"""Host-side image pre/post-processing (reference: src/diffusers/image_processor.py
VaeImageProcessor.preprocess:446 / postprocess:557), numpy + PIL, NHWC.

The device never sees PIL objects, and PIL is imported only where an image
is resized or a PIL image is made: preprocess produces float32 NHWC arrays in
[-1, 1] (bicubic resize, matching PIL's default used by the reference), and
postprocess maps decoded latents back to uint8 HWC images.  All batching is
plain numpy so it can run in dataloader worker threads.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np

ArrayLike = Union[np.ndarray, "PIL.Image.Image", Sequence]


def _pil():
    """PIL.Image, imported where an image is resized or a PIL image is made,
    so that numpy inputs at the output size never import PIL."""
    from PIL import Image

    return Image


def _is_pil(image) -> bool:
    return type(image).__module__.startswith("PIL.")


def _to_numpy(image) -> np.ndarray:
    """One image -> float32 HWC in [0, 1] (uint8 inputs divided by 255)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def resize_bicubic(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL-bicubic resize of an HWC float array (the reference resizes via
    PIL.Image.resize(..., BICUBIC) inside VaeImageProcessor)."""
    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    Image = _pil()
    chans = []
    for c in range(arr.shape[2]):
        im = Image.fromarray(arr[:, :, c].astype(np.float32), mode="F")
        chans.append(np.asarray(im.resize((width, height), Image.BICUBIC)))
    return np.stack(chans, axis=-1)


class ImageProcessor:
    """Normalize/denormalize + resize, reference VaeImageProcessor semantics."""

    def __init__(self, vae_scale_factor: int = 8, do_normalize: bool = True):
        self.vae_scale_factor = vae_scale_factor
        self.do_normalize = do_normalize

    def preprocess(
        self,
        image: ArrayLike,
        height: int | None = None,
        width: int | None = None,
    ) -> np.ndarray:
        """-> (B, H, W, C) float32 in [-1, 1]; H/W snapped down to a multiple
        of vae_scale_factor (reference image_processor.py VaeImageProcessor
        .preprocess 'resize to integer multiple of vae_scale_factor')."""
        if isinstance(image, (list, tuple)):
            imgs = [_to_numpy(i) for i in image]
        else:
            arr = image if _is_pil(image) else np.asarray(image)
            if isinstance(arr, np.ndarray) and arr.ndim == 4:
                imgs = [_to_numpy(a) for a in arr]
            else:
                imgs = [_to_numpy(image)]

        h0, w0 = imgs[0].shape[:2]
        height = height or (h0 // self.vae_scale_factor) * self.vae_scale_factor
        width = width or (w0 // self.vae_scale_factor) * self.vae_scale_factor
        imgs = [resize_bicubic(a, height, width) for a in imgs]
        batch = np.stack(imgs, axis=0)
        if self.do_normalize:
            # Inputs already in [-1, 1] pass through (reference warns + skips).
            if batch.min() >= 0.0:
                batch = batch * 2.0 - 1.0
        return np.ascontiguousarray(batch, dtype=np.float32)

    def postprocess(self, image: np.ndarray, output_type: str = "np") -> np.ndarray | List:
        """(B, H, W, C) in [-1, 1] -> uint8 np stack or PIL list.

        uint8 input passes through: the pipeline converts on DEVICE
        (same clip/scale/round math in fp32) so only 1/4 of the bytes cross
        the host link — at 1024² the fp32 fetch costs ~0.7 s via the relay."""
        arr = np.asarray(image)
        if arr.dtype == np.uint8 and output_type != "latent":
            arr8 = arr
            if output_type == "pil":
                Image = _pil()
                if arr8.shape[-1] == 1:
                    return [Image.fromarray(a[:, :, 0], mode="L") for a in arr8]
                return [Image.fromarray(a) for a in arr8]
            return arr8
        arr = arr.astype(np.float32)
        arr = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
        if output_type == "latent":
            return arr
        arr8 = (arr * 255.0).round().astype(np.uint8)
        if output_type == "pil":
            Image = _pil()
            if arr8.shape[-1] == 1:
                return [Image.fromarray(a[:, :, 0], mode="L") for a in arr8]
            return [Image.fromarray(a) for a in arr8]
        return arr8


def interpolate_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') on NHWC numpy (used for mask/depth
    downsampling to latent resolution, reference pipeline_brushnet.py:1190-1202)."""
    b, h, w, c = arr.shape
    rows = (np.arange(height) * h // height).astype(np.int64)
    cols = (np.arange(width) * w // width).astype(np.int64)
    return arr[:, rows][:, :, cols]
