"""SynMirror / MSD datasets, the port's counterpart of
`reflecting_reality_tpu/data/synmirror.py` (reference:
examples/brushnet/dataset/dataset.py).  Numpy in, numpy out: the same NHWC
float32 samples as the JAX package, which the loader stacks and uploads.

- extract_data_from_hdf5 (:205-223): colors / segmap==1 mirror mask ×255 /
  segmap==2 object mask / depth / normals / cam_states; masked_image = image
  with the mirror region zeroed (:61-68).
- apply_transforms_rgb (:71-82): /255 -> resize the SHORTER side to
  `resolution` (bicubic, torchvision.Resize semantics) -> centre crop -> [-1, 1].
- apply_transforms_mask (:85-96): /255 -> resize -> crop, stays [0, 1].
- apply_transforms_depth (:99-166): `max_scene_depth` clips to (max depth
  over the mirror mask + delta) and maps to [-1, 1] (or [0, 1]); `percentile`
  clips to the 2/98 percentiles.
- apply_transforms_normals (:168-192): image mode -> [-1, 1]; `ip_adapter`
  mode -> the unit mean normal over the mirror mask, shape (1, 3).
- tokenize_caption (:47-59): empty-prompt dropout + mirror-prompt prefix.
- decode_cam_states (:194-202): JSON bytes -> (cam2world, cam_K).
- MSDDataset (:274-321): png images/masks + Depth-Pro .npz depth.

Datasets index a list of CSV rows (dicts, `read_rows`), where the JAX
package takes a pandas frame.  `h5py` and `PIL` are imported only by the code
that reads HDF5 or PNG files or takes the PIL resize path, so the
latent-cache path imports neither.
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from reflecting_reality_tpu_torch.data import native as _native
from reflecting_reality_tpu_torch.data.rng import ItemRNG

MIRROR_PROMPT = "A perfect plane mirror reflection of "


def read_rows(path: str, limit: Optional[int] = None) -> List[Dict[str, str]]:
    """A CSV file's rows as dicts of column -> text (the standard `csv`
    module), at most `limit` of them."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows[:limit] if limit else rows


def _resize_shorter_bicubic(arr: np.ndarray, resolution: int) -> np.ndarray:
    """torchvision Resize(resolution): scale so the SHORTER side == resolution."""
    h, w = arr.shape[:2]
    if h <= w:
        nh, nw = resolution, max(1, round(w * resolution / h))
    else:
        nh, nw = max(1, round(h * resolution / w)), resolution
    if (nh, nw) == (h, w):
        # scale-1 bicubic is the identity kernel (cubic(0)=1, cubic(+-1)=0)
        return arr
    from PIL import Image

    squeeze = arr.ndim == 2
    a = arr[:, :, None] if squeeze else arr
    chans = []
    for c in range(a.shape[2]):
        im = Image.fromarray(a[:, :, c].astype(np.float32), mode="F")
        chans.append(np.asarray(im.resize((nw, nh), Image.BICUBIC)))
    out = np.stack(chans, axis=-1)
    return out[:, :, 0] if squeeze else out


def _center_crop(arr: np.ndarray, resolution: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max(0, (h - resolution) // 2)
    left = max(0, (w - resolution) // 2)
    return arr[top: top + resolution, left: left + resolution]


def get_masked_image(image: np.ndarray, mask: np.ndarray, invert: bool = True) -> np.ndarray:
    if mask.ndim == 2:
        nat = _native.masked_image(image, mask, invert=invert)
        if nat is not None:
            return nat
    keep = (mask != 255) if invert else (mask != 0)
    if image.ndim == 3 and keep.ndim == 2:
        keep = keep[:, :, None]
    return image * keep.astype(image.dtype)


def apply_transforms_rgb(image: np.ndarray, resolution: int = 512) -> np.ndarray:
    """uint8 HWC -> float32 (res, res, 3) in [-1, 1]: resize -> crop ->
    (x/255 - 0.5)/0.5 (crop and the elementwise normalise commute)."""
    if image.dtype == np.uint8 and image.ndim == 3:
        nat = _native.rgb_transform(image, resolution)
        if nat is not None:
            return nat
    x = image.astype(np.float32)
    x /= 255.0
    x = np.ascontiguousarray(_center_crop(_resize_shorter_bicubic(x, resolution), resolution))
    x -= 0.5
    x /= 0.5
    return x


def apply_transforms_mask(mask: np.ndarray, resolution: int = 512) -> np.ndarray:
    """uint8 HW -> float32 (res, res, 1) in [0, 1] (no normalise)."""
    if mask.dtype == np.uint8 and mask.ndim == 2:
        nat = _native.mask_transform(mask, resolution)
        if nat is not None:
            return nat
    x = mask.astype(np.float32) / 255.0
    x = _center_crop(_resize_shorter_bicubic(x, resolution), resolution)
    return x[:, :, None]


def apply_transforms_depth(
    depth_map: np.ndarray,
    mask: Optional[np.ndarray] = None,
    normalization_method: str = "max_scene_depth",
    max_scene_depth: float = 5.0,
    norm_range=(-1, 1),
    delta: float = 0.5,
    resolution: int = 512,
    **_: dict,
) -> np.ndarray:
    """-> float32 (res, res, 1) normalised depth."""
    depth = np.array(depth_map, dtype=np.float32)
    if mask is not None and mask.ndim == 3:
        mask = mask[:, :, 0]
    norm_range = list(norm_range)

    if (normalization_method == "max_scene_depth"
            and norm_range in ([0, 1], [-1, 1])
            and (mask is None or mask.dtype == np.uint8)):
        nat = _native.depth_transform(depth, mask, max_scene_depth, delta,
                                      to_pm1=(norm_range == [-1, 1]), resolution=resolution)
        if nat is not None:
            return nat

    if normalization_method == "percentile":
        d2, d98 = np.percentile(depth, 2), np.percentile(depth, 98)
        unit = (np.clip(depth, d2, d98) - d2) / (d98 - d2)
    elif normalization_method == "max_scene_depth":
        if mask is not None:
            max_scene_depth = float(depth[mask > 0].max()) + delta
        unit = np.clip(depth, 0, max_scene_depth) / max_scene_depth
    else:
        raise ValueError(normalization_method)

    if norm_range == [0, 1]:
        out = unit
    elif norm_range == [-1, 1]:
        out = 2.0 * unit - 1.0
    else:
        raise ValueError(norm_range)
    out = _center_crop(_resize_shorter_bicubic(out, resolution), resolution)
    return out[:, :, None].astype(np.float32)


def apply_transforms_normals(
    normals_map: np.ndarray,
    resolution: int = 512,
    mask: Optional[np.ndarray] = None,
    normals_conditioning_mode: str = "ip_adapter",
    **_: dict,
) -> np.ndarray:
    if normals_conditioning_mode == "ip_adapter":
        mean = normals_map[mask > 0].mean(axis=0)
        return (mean / np.linalg.norm(mean)).astype(np.float32)[None, :]  # (1, 3)
    x = normals_map.astype(np.float32)
    if x.ndim == 3:
        nat = _native.f32_img_transform(x, resolution)
        if nat is not None:
            return nat
    x = _center_crop(_resize_shorter_bicubic(x, resolution), resolution)
    return (x - 0.5) / 0.5


def normals_to_uint8(normals: np.ndarray) -> np.ndarray:
    """HDF5 normals are floats in [0, 1]: ×255 and round to a uint8 image
    (a bare cast would truncate all to 0).  uint8 input passes through."""
    arr = np.asarray(normals)
    if arr.dtype == np.uint8:
        return arr
    return np.round(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def decode_cam_states(cam_states: np.ndarray):
    data = json.loads(np.asarray(cam_states).tobytes().decode("utf-8"))
    return data["cam2world"], data["cam_K"]


def extract_data_from_hdf5(hdf5_data, random_flip: bool = False, keys=None
                           ) -> Dict[str, np.ndarray]:
    """Decode one SynMirror sample (reference dataset.py:205-223).  `keys`
    (default: all) skips the reads of planes the caller does not use."""
    want = set(keys) if keys is not None else {
        "image", "mask", "object_mask", "depth", "normals", "cam_states", "masked_image",
    }
    data: Dict[str, np.ndarray] = {}
    if want & {"mask", "object_mask", "masked_image"}:
        segmap = np.array(hdf5_data["category_id_segmaps"], dtype=np.uint8)
        if "mask" in want or "masked_image" in want:
            data["mask"] = (segmap == 1).astype(np.uint8) * 255
        if "object_mask" in want:
            data["object_mask"] = (segmap == 2).astype(np.uint8) * 255
    if want & {"image", "masked_image"}:
        data["image"] = np.array(hdf5_data["colors"], dtype=np.uint8)
    for key in ("depth", "normals", "cam_states"):
        if key in want:
            data[key] = np.array(hdf5_data[key])
    if "masked_image" in want:
        data["masked_image"] = get_masked_image(data["image"], data["mask"])
    if random_flip:
        for key in ("image", "mask", "object_mask", "masked_image", "depth", "normals"):
            if key in data:
                data[key] = np.fliplr(data[key])
    if keys is not None:
        data = {k: v for k, v in data.items() if k in want}
    return data


class HDF5Dataset:
    """SynMirror dataset over CSV rows (needs the `path` and caption columns)."""

    def __init__(
        self,
        data_root: str,
        rows: Sequence[Mapping[str, str]],
        tokenizer,
        resolution: int = 512,
        proportion_empty_prompts: float = 0.1,
        mirror_prompt: str = MIRROR_PROMPT,
        caption_column: str = "auto_caption",
        random_flip: bool = False,
        seed: Optional[int] = None,
        **kwargs,
    ):
        import h5py  # noqa: F401  (fail here, not in a loader thread)

        self.data_root = Path(data_root)
        self.rows = rows
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.proportion_empty_prompts = proportion_empty_prompts
        self.mirror_prompt = mirror_prompt
        self.caption_column = caption_column
        self.random_flip = random_flip
        self.rng = ItemRNG(seed)
        self.kwargs = kwargs

    def __len__(self):
        return len(self.rows)

    def tokenize_caption(self, caption: str, rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
        rng = rng if rng is not None else self.rng.for_item(0)
        if rng.random() < self.proportion_empty_prompts:
            caption = ""
        elif isinstance(caption, str):
            caption = self.mirror_prompt + caption
        return np.asarray(self.tokenizer([caption])[0], dtype=np.int32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        import h5py

        row = self.rows[index]
        caption = str(row[self.caption_column])
        # item-keyed rng: draws depend only on (seed, epoch, index)
        rng = self.rng.for_item(index)
        flip = self.random_flip and rng.random() < 0.5
        keys = {"image", "mask"}
        if not self.kwargs.get("hint_map_dir"):
            keys.add("masked_image")
        if self.kwargs.get("depth", False):
            keys.add("depth")
        if self.kwargs.get("normals_conditioning_mode", False):
            keys.add("normals")
        if self.kwargs.get("cam_states", False):
            keys.add("cam_states")
        with h5py.File(self.data_root / str(row["path"]), "r") as f:
            data = extract_data_from_hdf5(f, random_flip=flip, keys=keys)

        example = {
            "pixel_values": apply_transforms_rgb(data["image"], self.resolution),
            "masks": apply_transforms_mask(data["mask"], self.resolution),
            "input_ids": self.tokenize_caption(caption, rng),
        }
        hint_dir = self.kwargs.get("hint_map_dir")
        if hint_dir:
            from PIL import Image

            hint_path = os.path.join(str(self.data_root), hint_dir,
                                     str(row["path"]).replace("hdf5", "png"))
            hint = np.array(Image.open(hint_path))
            example["conditioning_pixel_values"] = apply_transforms_rgb(hint, self.resolution)
        else:
            example["conditioning_pixel_values"] = apply_transforms_rgb(
                data["masked_image"], self.resolution)
        if self.kwargs.get("depth", False):
            example["depths"] = apply_transforms_depth(
                data["depth"], mask=data["mask"], resolution=self.resolution, **self.kwargs)
        if self.kwargs.get("normals_conditioning_mode", False):
            example["normals"] = apply_transforms_normals(
                data["normals"], resolution=self.resolution, mask=data["mask"], **self.kwargs)
        if self.kwargs.get("cam_states", False):
            cam2world, cam_k = decode_cam_states(data["cam_states"])
            example["cam2world"] = np.asarray(cam2world, np.float32)
            example["cam_K"] = np.asarray(cam_k, np.float32)
        return example


class MSDDataset(HDF5Dataset):
    """Real-world Mirror Segmentation Dataset: png images/masks + Depth-Pro
    .npz depth (reference: dataset.py:274-321)."""

    def __init__(self, data_root, rows, tokenizer, mirror_prompt: str = "",
                 caption_column: str = "auto_caption", path_column: str = "path", **kwargs):
        self.data_root = Path(data_root)
        self.rows = rows
        self.tokenizer = tokenizer
        self.resolution = kwargs.pop("resolution", 512)
        self.proportion_empty_prompts = kwargs.pop("proportion_empty_prompts", 0.1)
        self.mirror_prompt = mirror_prompt
        self.caption_column = caption_column
        self.random_flip = kwargs.pop("random_flip", False)
        self.rng = ItemRNG(kwargs.pop("seed", None))
        self.kwargs = kwargs
        self.path_column = path_column
        self.images_dir = self.data_root / "images"
        self.masks_dir = self.data_root / "masks"
        self.depth_dir = self.data_root / "depth"

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        row = self.rows[index]
        caption = str(row[self.caption_column])
        image_path = str(row[self.path_column])
        image = np.array(Image.open(str(self.images_dir / image_path)))
        orig_mask = np.array(Image.open(str(self.masks_dir / image_path)))
        masked_image = get_masked_image(image, orig_mask)
        example = {
            "pixel_values": apply_transforms_rgb(image, self.resolution),
            "conditioning_pixel_values": apply_transforms_rgb(masked_image, self.resolution),
            "masks": apply_transforms_mask(orig_mask, self.resolution),
            "input_ids": self.tokenize_caption(caption, self.rng.for_item(index)),
        }
        if self.kwargs.get("depth", False):
            depth = np.load(self.depth_dir / image_path.replace("png", "npz"))["depth"]
            example["depths"] = apply_transforms_depth(
                depth, mask=orig_mask, resolution=self.resolution, **self.kwargs)
        return example
