"""The one generator of the benchmark's inputs, read from a cell's traffic
parameters and the seed.

Every seed does the same work: the inter-arrival gaps are the exponential
distribution's quantiles at the cell's rate, in one fixed order; the
prompt lengths and the mask areas are fixed ladders shuffled by the seed;
the pixels, the words and each request's own seed come from the seed.  So
a change of seed moves a cell's numbers no more than noise does.

PNG: a stored-filter encoder and a decoder of the five PNG filters, from
the standard library, for the requests' payloads and the served replies.
"""

from __future__ import annotations

import base64
import math
import struct
import zlib
from typing import Dict, List

import numpy as np

WORDS = ("a framed mirror on the wall of a bright room with wooden floor and white curtains "
         "reflecting the sofa lamp plants books chair table window painting shelf carpet door "
         "vase kitchen bathroom hallway bedroom golden silver round oval tall narrow large small "
         "modern old antique glass marble brick plaster evening morning light shadow").split()


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, salt)]))


def ladder(n: int, lo: float, hi: float) -> np.ndarray:
    """n values spread evenly over [lo, hi]."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def open_loop_schedule(params: dict, seed: int, seconds: float) -> List[dict]:
    """The requests due in a window of `seconds` at `params["rate"]` per
    second: offsets from the window's start, prompt, mask rectangle, seed.
    The arrivals are the same for every seed (the exponential quantiles in
    one fixed order): in a queue their order moves the tail more than
    anything the seed draws, so the seed draws only what each request asks."""
    rate = float(params["rate"])
    n = max(1, int(round(rate * seconds)))
    order = rng_for(0, 1)
    gaps = order.permutation(-np.log(1.0 - (np.arange(n) + 0.5) / n))  # exponential quantiles
    gaps *= seconds / gaps.sum()                                    # n gaps fill the window
    offsets = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return requests(params, seed, n, offsets.tolist())


def requests(params: dict, seed: int, n: int, offsets=None) -> List[dict]:
    rng = rng_for(seed, 2)
    lo, hi = params["prompt_words"]
    lengths = rng.permutation(np.round(ladder(n, lo, hi)).astype(int))
    a_lo, a_hi = params["mask_area"]
    areas = rng.permutation(ladder(n, a_lo, a_hi))
    aspects = rng.permutation(ladder(n, 0.5, 2.0))
    px = int(params["resolution"])
    out = []
    for i in range(n):
        words = rng.choice(len(WORDS), size=int(lengths[i]))
        h = min(px, int(round(px * math.sqrt(areas[i] * aspects[i]))))
        w = min(px, int(round(px * px * areas[i] / max(h, 1))))
        top, left = int(rng.integers(0, px - h + 1)), int(rng.integers(0, px - w + 1))
        out.append({"id": i, "offset": None if offsets is None else float(offsets[i]),
                    "prompt": " ".join(WORDS[j] for j in words),
                    "rect": [top, left, h, w], "seed": int(rng.integers(0, 2 ** 31 - 1)),
                    "pixels_seed": int(rng.integers(0, 2 ** 31 - 1))})
    return out


def request_arrays(req: dict, px: int) -> Dict[str, np.ndarray]:
    """A request's pixels: a smooth image with the hole zeroed (uint8 HWC),
    the mask (uint8, 255 = hole) and a 16-bit depth map."""
    rng = np.random.default_rng(req["pixels_seed"])
    coarse = rng.random((px // 32, px // 32, 4), dtype=np.float32)
    fine = np.repeat(np.repeat(coarse, 32, axis=0), 32, axis=1)
    yy, xx = np.mgrid[0:px, 0:px].astype(np.float32) / px
    image = np.clip(0.6 * fine[..., :3] + 0.3 * yy[..., None] + 0.1 * xx[..., None]
                    + 0.05 * rng.standard_normal((px, px, 3), dtype=np.float32), 0, 1)
    top, left, h, w = req["rect"]
    mask = np.zeros((px, px), np.uint8)
    mask[top:top + h, left:left + w] = 255
    image[mask > 0] = 0.0
    depth = np.clip(0.5 * fine[..., 3] + 0.5 * yy, 0, 1)
    return {"image": np.round(image * 255).astype(np.uint8), "mask": mask,
            "depth": np.round(depth * 65535).astype(np.uint16)}


def image_gaps(served: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """How far a served uint8 image lies from the reference's: the mean
    and root-mean-square difference in uint8 levels, the 99th percentile of
    the absolute difference, and the share of values more than 4 levels off."""
    d = np.abs(served.astype(np.float64) - reference.astype(np.float64))
    return {"image_mae": float(d.mean()), "image_rmse": float(np.sqrt((d ** 2).mean())),
            "image_p99": float(np.percentile(d, 99)), "image_off4": float((d > 4).mean())}


# --------------------------------------------------------------------- PNG

def png_encode(arr: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 3) or uint16 (H, W) -> PNG bytes (filter 0)."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    color = {1: 0, 3: 2, 4: 6}[ch]
    raw = arr.astype(">u2").tobytes() if depth == 16 else arr.tobytes()
    row = w * ch * depth // 8
    body = b"".join(b"\x00" + raw[r * row:(r + 1) * row] for r in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                                0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body, 1)) + chunk(b"IEND", b""))


def png_b64(arr: np.ndarray) -> str:
    return base64.b64encode(png_encode(arr)).decode("ascii")


def png_decode(data: bytes) -> np.ndarray:
    """8-bit grey / RGB / RGBA PNG bytes (any filters, no interlace) ->
    uint8 (H, W, C)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0:
        raise ValueError(f"only 8-bit, non-interlaced PNGs are read: {hdr}")
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    row = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, row + 1)
    out = np.zeros((h, row), np.int32)
    prev = np.zeros(row, np.int32)
    for r in range(h):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        elif f == 1:
            cur = line.copy()
            for x in range(ch, row):
                cur[x] = (cur[x] + cur[x - ch]) & 255
        else:
            cur = line.copy()
            for x in range(row):
                a = cur[x - ch] if x >= ch else 0
                b = prev[x]
                if f == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 255
                else:
                    c = prev[x - ch] if x >= ch else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 255
        out[r] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, ch)
