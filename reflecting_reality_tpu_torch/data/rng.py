"""Deterministic per-item host RNG for dataset-side randomness (empty-prompt
dropout, fliplr augmentation); the port's own copy of
`reflecting_reality_tpu/data/rng.py`, so the draws are identical by
construction.

Each item's generator is derived from (seed, epoch, index) alone, so the
draws do not depend on which loader thread handles the item, on batching or
on prefetch depth, and they differ across epochs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ItemRNG:
    """Per-item numpy Generators keyed by (seed, epoch, index).

    With seed=None every call returns a fresh OS-entropy generator.  The
    DataLoader sets `epoch` before each pass."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = seed
        self.epoch = 0

    def for_item(self, index: int) -> np.random.Generator:
        if self.seed is None:
            return np.random.default_rng()
        return np.random.default_rng(
            np.random.SeedSequence([int(self.seed), int(self.epoch), int(index)])
        )
