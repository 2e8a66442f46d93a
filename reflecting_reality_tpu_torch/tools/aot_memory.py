"""Memory plan of the full-size training step, and its measurement on the
card (counterpart of `reflecting_reality_tpu/tools/aot_memory.py`).

It answers "does this training recipe fit on one device, and by how much":
the full SD-1.5 MirrorFusion training step (UNet, BrushNet with 6
conditioning channels, VAE and CLIP text at the classes' default widths, the
recipe of `TrainConfig` below) at a batch per device, a resolution, a remat
policy, with or without EMA and with frozen modules in bf16 or fp32.

The plan holds no weights.  The modules are built on the meta device and
given fake tensors (`torch._subclasses.fake_tensor.FakeTensorMode`) on the
plan's device; then `make_train_step`'s own step runs once on a fake batch
while a dispatch mode counts the bytes of every storage the step creates,
each rounded up to the CUDA caching allocator's 512-byte blocks on the card.
The kernel wrappers give fake tensors their outputs without a launch, and
the step's host reads (the gradient norm, the finite check) take the finite
branch.  AdamW creates its state in the first update, so the peak of a
later step is the larger of the first step's peak before the update plus
that state, and its peak from the update on.  Keys, as JAX's with the
port's meaning:

- `argument_gib_per_device`: the parameters and buffers of the four modules,
  AdamW's state, the EMA shadow and the batch, alive between steps;
- `temp_gib_per_device`: the step's peak above them (activations, their
  recomputation under remat, gradients, the optimizer's temporaries);
- `output_gib_per_device`, `alias_gib_per_device`: 0, the update is in place;
- `peak_gib_per_device`: argument + temp, plus, with `n_devices` > 1, the
  flat buckets `parallel.multihost.all_reduce_mean` concatenates the
  gradients into (`allreduce_gib_per_device`: the two largest consecutive
  buckets, the new one made while the last is still held);
- `split`: the argument's parts and the temp, in GiB; `bytes`: the same,
  exact;
- `hbm_gib` (the card's memory as torch reports it; an H100's 80 GB with
  `--platform cpu`) and `fits` (peak + `RESERVE_GIB` within it).

Platforms (the port's entry points run on the card unless asked otherwise):

- `--platform gpu` (default): the plan on fake `cuda` tensors, which take
  the card's routes (flash attention saves O and lse, not the T x T
  logits; CUDA autocast), then the same recipe for real on the card at full
  width from seeded weights made there: `reset_peak_memory_stats()`, two
  steps, `max_memory_allocated()` -> `measured_peak_gib` beside the plan.  A
  CUDA out-of-memory error is the answer: `"fits": false` with the
  allocator's message.  One card runs the one-card step (`n_devices` 1), as
  JAX's tpu platform compiles the per-chip program.  Raises where CUDA is
  missing.
- `--platform cpu`: the plan on fake CPU tensors, for a machine without a
  card.  A CPU build of torch cannot run autograd over fake `cuda` tensors,
  so this plans the step as it runs on the CPU: plain attention keeps the
  fp32 T x T logits for the backward, and CPU autocast's casts differ from
  CUDA's, so its temp OVERSTATES the card's (the arguments are exact).
  Like JAX's cpu platform, it checks the program, not the budget: quote
  `--platform gpu`.

Usage:
    python -m reflecting_reality_tpu_torch.tools.aot_memory [--platform gpu|cpu] \\
        [--batch_per_chip 2] [--resolution 512] [--policy dots|full] \\
        [--train_base_unet] [--no_ema] [--ema_dtype bf16] [--frozen_fp32]
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import weakref
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

GIB = 1024 ** 3
H100_HBM_GIB = 79.18      # an H100 80GB HBM3's total_memory as torch reports it (--platform cpu)
RESERVE_GIB = 5.0         # outside the plan: the CUDA context and library handles,
                          # the caching allocator's reserved-but-free blocks
SEED = 0


def _block(nbytes: int, device: torch.device) -> int:
    """Bytes the allocator gives a storage: 512-byte blocks on the card."""
    return -(-nbytes // 512) * 512 if device.type == "cuda" else nbytes


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages alive on `device` that ops created or `add`
    registered, and their peak: each op's outputs are looked up by storage,
    a new storage counted until it is freed."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.live = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def add(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.device.type != self.device.type:
                continue
            st = t.untyped_storage()
            if id(st) in self._refs or st.nbytes() == 0:
                continue
            n = _block(st.nbytes(), self.device)
            self._refs[id(st)] = weakref.ref(st, functools.partial(self._free, id(st), n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.add(tree_leaves(out))
        return out


def _nbytes(tensors: Iterable[torch.Tensor], device: torch.device) -> int:
    """Exact bytes of the distinct storages among `tensors` on `device`."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == device.type:
            seen[id(t.untyped_storage())] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _fake_tensors(module: torch.nn.Module, device: torch.device,
                  dtype: Optional[torch.dtype]) -> None:
    """Replace a meta module's parameters and buffers by empty tensors on
    `device` (fake ones under a FakeTensorMode), floats in `dtype`."""
    made = {}

    def like(t):
        if id(t) not in made:
            dt = dtype if dtype is not None and t.is_floating_point() else t.dtype
            made[id(t)] = torch.empty(t.shape, dtype=dt, device=device)
        return made[id(t)]

    for mod in module.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(like(p), p.requires_grad)
        for name, b in mod._buffers.items():
            if b is not None:
                mod._buffers[name] = like(b)


def build_modules(tiny: bool, device: torch.device, frozen_dtype: torch.dtype,
                  unet_dtype: torch.dtype, fake: bool):
    """(unet, brushnet, vae, text) at SD-1.5's production widths (the class
    defaults) or the dry-run widths; trainable BrushNet in fp32.  `fake`:
    built on the meta device and given empty tensors on `device`; else
    seeded weights made on `device`."""
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    torch.manual_seed(SEED)
    with torch.device("meta" if fake else device):
        if tiny:
            cfg = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                       cross_attention_dim=768, norm_num_groups=4, layers_per_block=2)
            mods = (UNet2DConditionModel(**cfg), BrushNetModel(conditioning_channels=6, **cfg),
                    AutoencoderKL(block_out_channels=(4, 4, 4, 4), norm_num_groups=2),
                    CLIPTextModel(hidden_size=768, num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=32))
        else:
            mods = (UNet2DConditionModel(), BrushNetModel(conditioning_channels=6),
                    AutoencoderKL(), CLIPTextModel())
    dtypes = (unet_dtype, torch.float32, frozen_dtype, frozen_dtype)
    for m, dt in zip(mods, dtypes):
        if fake:
            _fake_tensors(m, device, dt)
        else:
            m.to(dt)
    return mods


def make_batch(n: int, resolution: int, device: torch.device, fake: bool) -> dict:
    """The loader's NHWC pixel batch (JAX's shapes and dtypes, int32 ids)."""
    shapes = {"pixel_values": 3, "conditioning_pixel_values": 3, "masks": 1, "depths": 1}
    if fake:
        batch = {k: torch.empty((n, resolution, resolution, c), device=device)
                 for k, c in shapes.items()}
        batch["input_ids"] = torch.empty((n, 77), dtype=torch.int32, device=device)
        return batch
    g = torch.Generator(device).manual_seed(SEED)
    batch = {k: torch.rand((n, resolution, resolution, c), generator=g, device=device) * 2 - 1
             for k, c in shapes.items()}
    batch["masks"] = (batch["masks"] > 0).float()
    batch["input_ids"] = torch.randint(0, 49408, (n, 77), generator=g, device=device,
                                       dtype=torch.int32)
    return batch


def _recipe(n_devices, batch_per_chip, resolution, policy, train_base_unet, use_ema,
            frozen_bf16, ema_dtype, tiny, device, fake):
    """The step of the recipe, its state and a batch -> (step, state, batch)."""
    from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step

    frozen_dt = torch.bfloat16 if frozen_bf16 else torch.float32
    unet, brushnet, vae, text = build_modules(
        tiny, device, frozen_dt, torch.float32 if train_base_unet else frozen_dt, fake)
    config = TrainConfig(
        train_base_unet=train_base_unet,
        use_ema=use_ema,
        ema_dtype=ema_dtype,
        gradient_checkpointing=True,
        gradient_checkpointing_policy=policy,
        snr_gamma=None,
        depth_conditioning_mode="concat",
    )
    step, init_state = make_train_step(unet, brushnet, vae, text, config,
                                       dtype=torch.bfloat16, device=device)
    batch = make_batch(batch_per_chip, resolution, device, fake)
    return step, init_state(), batch


def _argument_bytes(state, batch, device) -> Dict[str, int]:
    """Exact bytes of what lives between steps, by part."""
    modules = {**state.trainable, **state.frozen}
    trainable = [p for m in state.trainable.values() for p in m.parameters()]
    opt = [t for s in state.optimizer.state.values() for t in s.values()]
    return {
        "trainable_parameters": _nbytes(trainable, device),
        "frozen_parameters": _nbytes([t for m in modules.values() for t in m.parameters()],
                                     device) - _nbytes(trainable, device),
        "buffers": _nbytes([t for m in modules.values() for t in m.buffers()], device),
        "adamw_state": _nbytes(opt, device),
        "adamw_step_scalars": _nbytes([t for t in opt if t.dim() == 0], device),
        "ema": _nbytes([t for shadow in (state.ema or {}).values() for t in shadow.values()],
                       device),
        "batch": _nbytes(batch.values(), device),
    }


def allreduce_bytes(params, n_devices: int) -> int:
    """What `multihost.all_reduce_mean` holds at once over the gradients of
    `params` and the loss: the two largest consecutive flat buckets."""
    from reflecting_reality_tpu_torch.parallel.multihost import _buckets

    if n_devices <= 1:
        return 0
    with torch.device("meta"):
        grads = [torch.empty(p.shape, dtype=p.dtype) for p in params] + [torch.empty(())]
    sizes = [sum(t.numel() * t.element_size() for t in b) for b in _buckets(grads)]
    return max(a + b for a, b in zip(sizes, sizes[1:] + [0]))


def plan(n_devices=1, batch_per_chip=2, resolution=512, policy="dots", train_base_unet=False,
         use_ema=True, frozen_bf16=True, ema_dtype="fp32", tiny=False,
         device="cuda") -> dict:
    """The memory plan of one recipe on fake tensors on `device`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from reflecting_reality_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, state, batch = _recipe(n_devices, batch_per_chip, resolution, policy,
                                     train_base_unet, use_ema, frozen_bf16, ema_dtype, tiny,
                                     device, fake=True)
        live = LiveBytes(device)
        live.add([t for m in {**state.trainable, **state.frozen}.values()
                  for t in (*m.parameters(), *m.buffers())])
        live.add([t for shadow in (state.ema or {}).values() for t in shadow.values()])
        live.add(batch.values())
        before_update = {}

        def mark(*_):
            before_update.setdefault("peak", live.peak)

        hook = state.optimizer.register_step_pre_hook(mark)
        with live:
            step(state, batch, None)
        hook.remove()
        parts = _argument_bytes(state, batch, device)
        argument = sum(v for k, v in parts.items() if k != "adamw_step_scalars")
        adamw_blocks = sum(_block(t.untyped_storage().nbytes(), device)
                           for s in state.optimizer.state.values() for t in s.values()
                           if t.device.type == device.type)
        peak = max(before_update["peak"] + adamw_blocks, live.peak)
        allreduce = allreduce_bytes(state.params, n_devices)
    parts["temp"] = peak - argument
    parts["allreduce"] = allreduce
    stats = {
        "n_devices": n_devices,
        "batch_per_chip": batch_per_chip,
        "resolution": resolution,
        "remat_policy": policy,
        "train_base_unet": train_base_unet,
        "use_ema": use_ema,
        "ema_dtype": ema_dtype,
        "frozen_bf16": frozen_bf16,
        "argument_gib_per_device": round(argument / GIB, 3),
        "temp_gib_per_device": round(parts["temp"] / GIB, 3),
        "output_gib_per_device": 0.0,
        "alias_gib_per_device": 0.0,
        "allreduce_gib_per_device": round(allreduce / GIB, 3),
        "peak_gib_per_device": round((peak + allreduce) / GIB, 3),
        "split": {k: round(v / GIB, 3) for k, v in parts.items()},
        "bytes": dict(parts, argument=argument, peak=peak + allreduce),
    }
    return stats


def measure(batch_per_chip=2, resolution=512, policy="dots", train_base_unet=False,
            use_ema=True, frozen_bf16=True, ema_dtype="fp32") -> dict:
    """The same recipe for real on the card, seeded weights made there: peak
    allocated and reserved over two steps, or the out-of-memory error."""
    device = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()       # what the calling process holds already
    torch.cuda.reset_peak_memory_stats()
    out = {}
    try:
        step, state, batch = _recipe(1, batch_per_chip, resolution, policy, train_base_unet,
                                     use_ema, frozen_bf16, ema_dtype, False, device, fake=False)
        gen = torch.Generator(device).manual_seed(SEED)
        for _ in range(2):
            _, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        out = {"measured_peak_gib": (torch.cuda.max_memory_allocated() - base) / GIB,
               "measured_reserved_gib": torch.cuda.max_memory_reserved() / GIB,
               "measured_argument_gib": (torch.cuda.memory_allocated() - base) / GIB,
               "measured_baseline_gib": base / GIB,
               "measured_loss": float(metrics["loss"]), "fits": True}
    except torch.cuda.OutOfMemoryError as e:
        out = {"fits": False, "oom": str(e).splitlines()[0]}
    finally:
        step = state = batch = None
        gc.collect()
        torch.cuda.empty_cache()
    return out


def analyze(n_devices: int = 8, batch_per_chip: int = 2, resolution: int = 512,
            policy: str = "dots", train_base_unet: bool = False,
            use_ema: bool = True, compute_dtype=torch.bfloat16, tiny: bool = False,
            frozen_bf16: bool = True, ema_dtype: str = "fp32", platform: str = "gpu") -> dict:
    """Plan the recipe (and, on the gpu platform, measure it) -> stats dict.

    tiny=True swaps in the dry-run-sized models (plumbing check only).  The
    step computes in bf16 autocast (`compute_dtype`, as JAX's)."""
    if compute_dtype != torch.bfloat16:
        raise ValueError("the planned step computes in bf16")
    device = "cuda" if platform == "gpu" else "cpu"
    n = 1 if platform == "gpu" else n_devices
    stats = plan(n, batch_per_chip, resolution, policy, train_base_unet, use_ema,
                 frozen_bf16, ema_dtype, tiny, device)
    stats["platform"] = platform
    stats["hbm_gib"] = (torch.cuda.get_device_properties(0).total_memory / GIB
                        if platform == "gpu" else H100_HBM_GIB)
    stats["fits"] = stats["planned_fits"] = (
        stats["peak_gib_per_device"] + RESERVE_GIB <= stats["hbm_gib"])
    if platform == "gpu" and not tiny:
        stats.update(measure(batch_per_chip, resolution, policy, train_base_unet, use_ema,
                             frozen_bf16, ema_dtype))
    return stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="memory plan of the full-size training step")
    p.add_argument("--n_devices", type=int, default=8,
                   help="data-parallel devices (--platform cpu); the per-device figure adds "
                        "the gradient all-reduce's buckets when > 1")
    p.add_argument("--batch_per_chip", type=int, default=2)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--policy", choices=["dots", "full"], default="dots")
    p.add_argument("--train_base_unet", action="store_true")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--frozen_fp32", action="store_true",
                   help="keep frozen modules in fp32 storage (default bf16, "
                        "the reference mixed-precision policy)")
    p.add_argument("--ema_dtype", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="gpu: plan on fake cuda tensors (the card's routes), then run the "
                        "recipe on the card and report its measured peak; one card, "
                        "n_devices 1.  cpu: plan the step as it runs on the CPU (plain "
                        "attention), for a machine without a card: the arguments are exact, "
                        "the temp OVERSTATES the card's")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    stats = analyze(args.n_devices, args.batch_per_chip, args.resolution, args.policy,
                    args.train_base_unet, not args.no_ema, frozen_bf16=not args.frozen_fp32,
                    ema_dtype=args.ema_dtype, platform=args.platform)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
