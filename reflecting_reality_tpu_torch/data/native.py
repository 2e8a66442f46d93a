"""ctypes binding of the native sample transforms (`native/transforms.cpp`),
the port's counterpart of `reflecting_reality_tpu/data/native.py`.

These are host transforms run by the loader's threads, not device kernels:
a ctypes call releases the interpreter lock, so the per-sample pixel work of
several loader threads runs in parallel.  Every entry point has a numpy/PIL
path in `data/synmirror.py` that gives bit-identical results.

Loading: the first call builds `native/transforms.cpp` with g++ into
`data/_build/` of this package (a directory .gitignore lists), or into the
directory `core.jit_cache.enable_compilation_cache` named
(`--compilation_cache_dir`), unless a library built from the same source is
there already, and loads it.
`RR_DISABLE_NATIVE=1`, a missing g++ or a failed build select the numpy
path.  Which path was taken is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from reflecting_reality_tpu_torch.core import jit_cache

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "transforms.cpp"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i = ctypes.c_int
_f = ctypes.c_float


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return (jit_cache.cache_dir() or DEFAULT_BUILD_DIR) / f"libtransforms-{digest}.so"


def _build(so_path: Path) -> None:
    """g++ into a temporary name, then an atomic rename, so a concurrent
    builder never leaves a truncated library behind."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed, or None for the
    numpy path.  Thread-safe: loader threads may race to the first call."""
    if _tried:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("RR_DISABLE_NATIVE"):
        logger.info("native transforms: RR_DISABLE_NATIVE set, using the numpy path")
        return None
    try:
        so_path = library_path()
        if not so_path.exists():
            _build(so_path)
        lib = ctypes.CDLL(str(so_path))
        lib.rr_abi_version.restype = ctypes.c_int
        if lib.rr_abi_version() != ABI_VERSION:
            raise OSError(f"ABI {lib.rr_abi_version()}, want {ABI_VERSION}")
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native transforms unavailable (%s), using the numpy path", e)
        return None
    lib.rr_rgb_transform.argtypes = [_u8, _i, _i, _i, _i, _f32]
    lib.rr_rgb_transform.restype = None
    lib.rr_mask_transform.argtypes = [_u8, _i, _i, _i, _f32]
    lib.rr_mask_transform.restype = None
    lib.rr_f32_img_transform.argtypes = [_f32, _i, _i, _i, _i, _f32]
    lib.rr_f32_img_transform.restype = None
    lib.rr_depth_transform.argtypes = [_f32, ctypes.c_void_p, _i, _i, _f, _f, _i, _i, _f32]
    lib.rr_depth_transform.restype = ctypes.c_int
    lib.rr_masked_image.argtypes = [_u8, _u8, _i, _i, _i, ctypes.c_uint8, _u8]
    lib.rr_masked_image.restype = None
    logger.info("native transforms: loaded %s", so_path)
    _lib = lib
    return _lib


def rgb_transform(image: np.ndarray, resolution: int) -> Optional[np.ndarray]:
    """u8 HWC -> f32 (res, res, C) in [-1, 1], or None without the library."""
    lib = load()
    if lib is None or image.dtype != np.uint8 or image.ndim != 3:
        return None
    image = np.ascontiguousarray(image)
    h, w, c = image.shape
    out = np.empty((resolution, resolution, c), np.float32)
    lib.rr_rgb_transform(image, h, w, c, resolution, out)
    return out


def mask_transform(mask: np.ndarray, resolution: int) -> Optional[np.ndarray]:
    """u8 HW -> f32 (res, res, 1) in [0, 1], or None."""
    lib = load()
    if lib is None or mask.dtype != np.uint8 or mask.ndim != 2:
        return None
    mask = np.ascontiguousarray(mask)
    h, w = mask.shape
    out = np.empty((resolution, resolution, 1), np.float32)
    lib.rr_mask_transform(mask, h, w, resolution, out[:, :, 0])
    return out


def f32_img_transform(img: np.ndarray, resolution: int) -> Optional[np.ndarray]:
    """f32 HWC in [0, 1] -> f32 (res, res, C) in [-1, 1] (normals image mode)."""
    lib = load()
    if lib is None or img.ndim != 3:
        return None
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty((resolution, resolution, c), np.float32)
    lib.rr_f32_img_transform(img, h, w, c, resolution, out)
    return out


def depth_transform(depth: np.ndarray, mask: Optional[np.ndarray], max_scene_depth: float,
                    delta: float, to_pm1: bool, resolution: int) -> Optional[np.ndarray]:
    """max_scene_depth-mode depth normalisation + resize + crop, or None
    (also for an empty mask, where the numpy path raises)."""
    lib = load()
    if lib is None or depth.ndim != 2:
        return None
    depth = np.ascontiguousarray(depth, np.float32)
    h, w = depth.shape
    mask_p = None
    if mask is not None:
        mask = np.ascontiguousarray(mask)
        if mask.dtype != np.uint8 or mask.shape != depth.shape:
            return None
        mask_p = mask.ctypes.data_as(ctypes.c_void_p)
    out = np.empty((resolution, resolution, 1), np.float32)
    rc = lib.rr_depth_transform(depth, mask_p, h, w, float(max_scene_depth), float(delta),
                                int(to_pm1), resolution, out[:, :, 0])
    return out if rc == 0 else None


def masked_image(image: np.ndarray, mask: np.ndarray, invert: bool = True
                 ) -> Optional[np.ndarray]:
    """The image with the mask region zeroed (u8), or None."""
    lib = load()
    if (lib is None or image.dtype != np.uint8 or mask.dtype != np.uint8
            or image.ndim != 3 or mask.ndim != 2 or image.shape[:2] != mask.shape):
        return None
    image = np.ascontiguousarray(image)
    mask = np.ascontiguousarray(mask)
    h, w, c = image.shape
    out = np.empty_like(image)
    lib.rr_masked_image(image, mask, h, w, c, 255 if invert else 0, out)
    return out
