"""The MirrorFusion training step and its pieces (counterpart of
`reflecting_reality_tpu/training/`): `train_step`, `lr_schedules`, `ema`,
`checkpoint` (reference-layout checkpoints, resume, async save) and
`profiling`."""

from reflecting_reality_tpu_torch.training.ema import ema_update
from reflecting_reality_tpu_torch.training.lr_schedules import get_schedule
from reflecting_reality_tpu_torch.training.train_step import (
    TrainConfig,
    TrainState,
    assemble_conditioning_latents,
    make_optimizer,
    make_train_step,
    nearest_resize,
    resolve_device_cache,
)

__all__ = [
    "TrainConfig", "TrainState", "assemble_conditioning_latents", "ema_update",
    "get_schedule", "make_optimizer", "make_train_step", "nearest_resize",
    "resolve_device_cache",
]
