"""Dataset over precomputed VAE moments (`tools/precompute_latents.py`), the
port's counterpart of `reflecting_reality_tpu/data/latent_cache.py`.

Serves `latent_moments` / `cond_latent_moments` (+ per-mode extras) instead
of full-resolution pixels; the train step draws from the cached
DiagonalGaussian each step, so the two VAE encodes leave the step.
Captions still come from the CSV at train time (the empty-prompt dropout
stays stochastic per epoch).  random_flip is unsupported by design: the
cache holds one deterministic variant.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from reflecting_reality_tpu_torch.data.rng import ItemRNG


def cache_name(row: Mapping[str, str], index: int) -> str:
    """The per-sample cache file name shared by the precompute tool and the
    dataset: uid_<stem>.npz when the row has a uid, else <index>.npz."""
    try:
        uid = row["uid"]
    except (KeyError, IndexError):
        return f"{index}.npz"
    stem = os.path.splitext(os.path.basename(str(row["path"])))[0]
    return f"{uid}_{stem}.npz"


class LatentCachedDataset:
    """SynMirror training samples from a moments cache directory."""

    def __init__(
        self,
        cache_dir: str,
        rows: Sequence[Mapping[str, str]],
        tokenizer,
        proportion_empty_prompts: float = 0.1,
        mirror_prompt: str = "A perfect plane mirror reflection of ",
        caption_column: str = "auto_caption",
        seed: Optional[int] = None,
        **_: dict,
    ):
        self.cache_dir = cache_dir
        self.rows = rows
        self.tokenizer = tokenizer
        self.proportion_empty_prompts = proportion_empty_prompts
        self.mirror_prompt = mirror_prompt
        self.caption_column = caption_column
        self.rng = ItemRNG(seed)
        missing = [cache_name(rows[i], i) for i in range(min(len(rows), 16))
                   if not os.path.exists(os.path.join(cache_dir, cache_name(rows[i], i)))]
        if missing:
            raise FileNotFoundError(
                f"latent cache at {cache_dir} is missing {missing[:3]}... - "
                "run tools/precompute_latents.py first")

    def __len__(self):
        return len(self.rows)

    def tokenize_caption(self, caption: str, rng=None) -> np.ndarray:
        rng = rng if rng is not None else self.rng.for_item(0)
        if rng.random() < self.proportion_empty_prompts:
            caption = ""
        elif isinstance(caption, str):
            caption = self.mirror_prompt + caption
        return np.asarray(self.tokenizer([caption])[0], dtype=np.int32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        with np.load(os.path.join(self.cache_dir, cache_name(row, index))) as z:
            example = {k: z[k].astype(np.float32) for k in z.files}
        example["input_ids"] = self.tokenize_caption(
            str(row[self.caption_column]), self.rng.for_item(index))
        return example


class DeviceCacheIndexDataset:
    """Index-only view of a LatentCachedDataset for `--device_cache`: the
    sample arrays live on the card (uploaded once from `materialize_cache`),
    so the host path per step is the index and the tokenised caption, with
    the same item-RNG stream as the host-cached path."""

    def __init__(self, inner: LatentCachedDataset):
        self.inner = inner
        self.rng = inner.rng  # the DataLoader advances .rng.epoch per pass

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.inner.rows[index]
        return {
            "index": np.asarray(index, np.int32),
            "input_ids": self.inner.tokenize_caption(
                str(row[self.inner.caption_column]), self.inner.rng.for_item(index)),
        }


def materialize_cache(dataset: LatentCachedDataset,
                      transport_dtype: Optional[torch.dtype] = None,
                      max_bytes: Optional[int] = None,
                      transport_exempt: tuple = ()) -> Dict[str, torch.Tensor]:
    """The whole moments cache stacked into host tensors {key: (N, ...)} for
    a one-time upload.  float32 arrays are cast to `transport_dtype` (a torch
    dtype; None keeps float32), except keys in `transport_exempt`.  Raises if
    the footprint exceeds `max_bytes`."""
    n = len(dataset)
    first = {k: v for k, v in dataset[0].items() if k != "input_ids"}

    def casts(k, v):
        return transport_dtype is not None and k not in transport_exempt \
            and v.dtype == np.float32

    t_itemsize = torch.empty((), dtype=transport_dtype).element_size() if transport_dtype else 0
    per_sample = sum(v.size * (t_itemsize if casts(k, v) else v.itemsize)
                     for k, v in first.items())
    total = per_sample * n
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"device cache would need {total / 1e9:.2f} GB for {n} samples "
            f"({per_sample / 1e3:.0f} KB each) > limit {max_bytes / 1e9:.2f} GB"
            " - raise RR_DEVICE_CACHE_MAX_GB or drop --device_cache")
    out = {k: np.empty((n,) + v.shape, v.dtype) for k, v in first.items()}
    for i in range(n):
        sample = dataset[i]
        for k in out:
            out[k][i] = sample[k]
    return {k: torch.from_numpy(v).to(transport_dtype) if casts(k, v) else torch.from_numpy(v)
            for k, v in out.items()}
