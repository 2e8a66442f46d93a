"""The MirrorFusion training step (counterpart of
`reflecting_reality_tpu/training/train_step.py`; reference:
examples/brushnet/train_brushnet_mirror.py:1346-1523).

Per step, with the same contracts as the JAX module:
- VAE-encode pixel_values and conditioning_pixel_values, sample the
  posterior (explicit `torch.Generator`), ×0.18215 (:1351-1355);
- conditioning latents: nearest-resized mask, then depth by `concat` (1
  channel, resized) or `latents` (3-channel repeat, VAE-encoded), normals by
  `concat` or `latents` (:1357-1405); precomputed encoder moments in the
  batch (`latent_moments`, ...) replace the encoder with a draw from the
  cached posterior;
- noise ~ N(0, 1), t ~ U[0, 1000), DDPM `add_noise` (:1408-1416);
- frozen CLIP text encode (:1419-1420);
- BrushNet -> 12 + 1 + 15 residuals -> the UNet (:1422), both given the
  timesteps (BrushNet's `time_embedding` trains);
- MSE against ε or v, optional SNR-γ weighting (:1427-1451);
- clip by global norm (optax semantics: g·max_norm/‖g‖ when ‖g‖ ≥ max_norm),
  AdamW with the LR schedule, optional EMA (:1459-1466).

Normals `ip_adapter` mode (JAX :216-268, :318-326): `make_train_step` takes
a `NormalProjModel`; the batch's `normals` (B, 1, 3) is freq-encoded and
projected to one token, appended after the 77 text tokens for the UNet only
(BrushNet sees the plain text).  The UNet joins the trainable set, but only
its `to_k_ip`/`to_v_ip` take gradients (all of it with `train_base_unet`);
`normal_proj` trains.  AdamW is built over the trainable leaves only, so
weight decay never moves a frozen leaf (JAX routes them around AdamW with
`optax.masked`), and the global norm is JAX's, whose frozen gradients are
zeros.  The EMA shadows the trainable leaves; a checkpoint's `ema/unet`
fills the frozen ones from the module.

What is PyTorch here rather than JAX: the modules hold their parameters, so
`TrainState` holds modules and the optimizer; the step updates them in place
and returns the same state object.  The latents, conditioning and text
states are computed under `no_grad` (the JAX `stop_gradient`s, :282-294).
Frozen modules get `requires_grad_(False)`; the gradient still flows through
the frozen UNet's activations to BrushNet.  Under `dtype=torch.bfloat16` the
forwards run under `torch.autocast` in bf16, the trainable modules keep fp32
master weights, and the caller stores the frozen ones in bf16, as
`cli/train.py:308-320` does.  On the card every attention that needs a
gradient runs kernels B1/B3/B4 and every GroupNorm kernel B2 (with its plain
backward), through the autograd Functions of `ops/kernels/`.

At fp32 the forward and backward run under `core.device.fp32_convolutions`
(cuDNN convolutions without TF32; ROADMAP.md C4).

The non-finite guard needs the host to see the loss and the gradient norm
(one synchronisation a step): a NaN/Inf in either leaves the parameters, the
AdamW moments, the accumulated gradients and the EMA untouched (:370-389).
On fake tensors (`tools/aot_memory.py` runs this step to plan its memory)
the host reads see no value: the step takes the finite branch and clips.
Spans (`core/tracing.py`): `rr.train.step` holds `rr.train.forward`,
`rr.train.backward`, `rr.train.all_reduce`, the host reads
(`rr.train.host_read`: the guard's, and the clip's inside
`rr.train.optimizer`) and `rr.train.optimizer`.
`gradient_accumulation_steps = K` averages K micro-steps and updates on the
K-th, like `optax.MultiSteps`; the LR schedule counts updates, not
micro-steps.  `draws=` lets a caller pass the step's random numbers in (the
VAE posterior noise, the diffusion noise and the timesteps), so a test can
reproduce the JAX package's `jax.random` draws.

Data parallel (JAX runs one program over a "data" mesh on a global batch):
inside a `torch.distributed` group of N ranks (`parallel/multihost.py`),
each rank takes `train_batch_size` rows of a global batch of N times that.
Every rank draws the global batch's random numbers from the same generator
and keeps its own rows (`BatchShard`), so N ranks compute what one process
computes on the whole batch with the same seed; `draws=` are the global
batch's too.  The gradients and the loss are averaged across the ranks
after the backward pass (bucketed `all_reduce`), before the global norm,
so clipping and the non-finite skip see the global gradient and every rank
takes the same branch; `init_state` broadcasts rank 0's trainable
parameters, so the parameters, AdamW's moments and the EMA stay identical
on every rank.  `--scale_lr` scales by N.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.core.device import fp32_convolutions, resolve_device
from reflecting_reality_tpu_torch.models.vae import DiagonalGaussian
from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.schedulers.common import (
    NoiseSchedule,
    add_noise,
    compute_snr,
    get_velocity,
)
from reflecting_reality_tpu_torch.training.ema import ema_update
from reflecting_reality_tpu_torch.training.lr_schedules import get_schedule

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference CLI flags (train_brushnet_mirror.py:359-793);
    the fields and defaults of the JAX `TrainConfig`."""

    learning_rate: float = 1e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_num_cycles: float = 1.0
    lr_power: float = 1.0
    max_train_steps: int = 20000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    snr_gamma: Optional[float] = None
    prediction_type: str = "epsilon"
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    # "full": recompute both branch forwards in the backward pass (reference
    # enable_gradient_checkpointing); "dots": save the outputs of the matrix
    # products and convolutions, recompute the rest (see `dots_policy`)
    gradient_checkpointing_policy: str = "full"
    train_base_unet: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    ema_dtype: str = "fp32"          # or "bf16": a half-size shadow copy
    depth_conditioning_mode: Optional[str] = "concat"
    normals_conditioning_mode: Optional[str] = None
    scaling_factor: float = 0.18215
    num_train_timesteps: int = 1000


@dataclasses.dataclass
class TrainState:
    """The modules, the optimizer and the counters of a training run."""

    step: int                              # train_step calls so far
    trainable: Dict[str, nn.Module]        # {"brushnet": ..., ["unet": ...]}
    frozen: Dict[str, nn.Module]           # {"vae": ..., "text": ..., ["unet": ...]}
    optimizer: torch.optim.Optimizer
    params: List[nn.Parameter]             # the trainable parameters, optimizer order
    ema: Optional[Dict[str, Dict[str, torch.Tensor]]] = None  # shadows by module, name
    updates: int = 0                       # optimizer updates applied (the LR count)
    micro_step: int = 0                    # micro-steps accumulated towards the next update
    grad_acc: Optional[List[torch.Tensor]] = None  # running mean of their gradients


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows of a data-parallel step's global batch: rows
    [rank·b, (rank+1)·b) of every global draw, b the local batch."""

    rank: int = 0
    world: int = 1

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor over the global batch -> this rank's rows."""
        if self.world == 1:
            return x
        b = x.shape[0] // self.world
        return x[self.rank * b:(self.rank + 1) * b]

    def randn(self, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """N(0, 1) noise for the global batch, this rank's rows of it."""
        return self.local(torch.randn((shape[0] * self.world, *shape[1:]), generator=generator,
                                      device=device))

    def randint(self, high: int, n: int, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
        """U[0, high) integers for the global batch, this rank's `n`."""
        return self.local(torch.randint(0, high, (n * self.world,), generator=generator,
                                        device=device))


def nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) with torch F.interpolate(mode='nearest')
    indexing, src = floor(dst·in/out) (the JAX `nearest_resize_nhwc`)."""
    rows = torch.arange(h, device=x.device) * x.shape[2] // h
    cols = torch.arange(w, device=x.device) * x.shape[3] // w
    return x[:, :, rows][:, :, :, cols]


def _nchw(x: Any, device: torch.device) -> torch.Tensor:
    """An NHWC batch entry (numpy or tensor) as an NCHW tensor on `device`."""
    return torch.as_tensor(x, device=device).permute(0, 3, 1, 2)


def resolve_device_cache(batch: Mapping[str, Any], cache: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A step's batch gathered from a device-resident sample cache (the JAX
    `resolve_device_cache`): `cache` holds the whole moments dataset as
    (N, ...) tensors on the card, `batch` only `index` (B,) and `input_ids`,
    so the per-step upload is a few hundred bytes."""
    device = next(iter(cache.values())).device
    index = torch.as_tensor(batch["index"], device=device).long()
    full = {k: v.index_select(0, index) for k, v in cache.items()}
    full["input_ids"] = batch["input_ids"]
    return full


def _sample(dist: DiagonalGaussian, noise: Optional[torch.Tensor],
            generator: Optional[torch.Generator], shard: BatchShard = BatchShard()
            ) -> torch.Tensor:
    """A posterior draw; `noise` (or the generator's draw) is the global
    batch's, of which `shard` keeps this rank's rows."""
    if noise is None:
        noise = shard.randn(dist.mean.shape, generator, dist.mean.device)
    else:
        noise = shard.local(noise)
    return dist.mean + dist.std * noise.to(dist.mean.device, dist.mean.dtype)


def assemble_conditioning_latents(
    vae: nn.Module, batch: Mapping[str, Any], config: TrainConfig,
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None, shard: BatchShard = BatchShard(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (latents, conditioning latents), NCHW, from an NHWC batch (the JAX
    version's third output, the ip_adapter normal, is the batch's `normals`
    as it is: the step reads it there).
    The posterior draws are taken from `vae_noise` ("latents", "cond",
    "depth", "normals": NCHW noise shaped like each latent) where given, else
    from `generator`, the global batch's, of which `shard` keeps this
    rank's rows.  Cached moments are cast to `dtype` first, as the JAX
    step casts every float input to its compute dtype, so a batch uploaded
    in that dtype gives the same bits.  Call it under `no_grad` (and
    autocast for bf16)."""
    device = next(vae.parameters()).device
    vae_noise = vae_noise or {}

    def enc(key: str, img: torch.Tensor) -> torch.Tensor:
        return (_sample(vae.encode(img), vae_noise.get(key), generator, shard)
                * config.scaling_factor)

    def from_cache(key: str, moments_key: str) -> torch.Tensor:
        dist = DiagonalGaussian.from_moments(_nchw(batch[moments_key], device).to(dtype))
        return _sample(dist, vae_noise.get(key), generator, shard) * config.scaling_factor

    cached = "latent_moments" in batch
    if cached:
        latents = from_cache("latents", "latent_moments")
        cond = from_cache("cond", "cond_latent_moments")
    else:
        latents = enc("latents", _nchw(batch["pixel_values"], device))
        cond = enc("cond", _nchw(batch["conditioning_pixel_values"], device))
    hl, wl = latents.shape[2:]

    def resized(key: str) -> torch.Tensor:
        return nearest_resize(_nchw(batch[key], device), hl, wl).to(cond.dtype)

    cond = torch.cat([cond, resized("masks")], dim=1)
    if config.depth_conditioning_mode == "concat":
        cond = torch.cat([cond, resized("depths")], dim=1)
    elif config.depth_conditioning_mode == "latents":
        d = (from_cache("depth", "depth_latent_moments") if cached
             else enc("depth", _nchw(batch["depths"], device).repeat(1, 3, 1, 1)))
        cond = torch.cat([cond, d.to(cond.dtype)], dim=1)

    if config.normals_conditioning_mode == "concat":
        cond = torch.cat([cond, resized("normals")], dim=1)
    elif config.normals_conditioning_mode == "latents":
        n = (from_cache("normals", "normals_latent_moments") if cached
             else enc("normals", _nchw(batch["normals"], device)))
        cond = torch.cat([cond, n.to(cond.dtype)], dim=1)
    return latents, cond


def lr_schedule(config: TrainConfig, data_parallel_size: int = 1) -> Callable[[int], float]:
    """The LR as a function of the update count.  `scale_lr` multiplies by
    the data-parallel size (the JAX mesh size; the batch is global)."""
    lr = config.learning_rate * (data_parallel_size if config.scale_lr else 1)
    return get_schedule(
        config.lr_scheduler, lr, config.lr_warmup_steps, config.max_train_steps,
        num_cycles=config.lr_num_cycles, power=config.lr_power,
    )


def make_optimizer(config: TrainConfig, params, data_parallel_size: int = 1,
                   ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over `params` and its LR schedule.  torch's AdamW is optax's
    `adamw`: decoupled decay p·(1 − lr·wd) and ε added to sqrt(v̂).  On
    CUDA parameters the multi-tensor (foreach) update, PyTorch's default
    there, is asked for by name: a fake tensor's type hides it from that
    default, and the memory plan (`tools/aot_memory.py`) must run the
    update, and its whole-list temporaries, that the card runs."""
    params = list(params)
    schedule = lr_schedule(config, data_parallel_size)
    optimizer = torch.optim.AdamW(
        params, lr=schedule(0), betas=(config.adam_beta1, config.adam_beta2),
        eps=config.adam_epsilon, weight_decay=config.adam_weight_decay,
        foreach=True if params and all(p.device.type == "cuda" for p in params) else None,
    )
    return optimizer, schedule


# The "dots" policy, counterpart of JAX's
# `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`: what counts as
# a dot is a matrix product without batch dimensions (`aten.mm`,
# `aten.addmm`: every Linear, 2-D or flattened) and a convolution
# (`aten.convolution`: every conv of the UNet and BrushNet).  Their outputs
# are saved; everything else is recomputed in the backward pass: norms,
# activations, the attention's batched products and the flash forward,
# which is an opaque autograd Function here as the Pallas call is to the
# JAX policy.  So B1 launches 10 times a step under either policy (5 in the
# forward, 5 again when the forward is recomputed) and B3/B4 5 each, as
# under "full"; without checkpointing it is 5/5/5.
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.convolution.default)


def dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(dots_policy)


def denoise(unet: nn.Module, brushnet: nn.Module, noisy: torch.Tensor, timesteps: torch.Tensor,
            ehs: torch.Tensor, cond: torch.Tensor, gradient_checkpointing: bool = False,
            policy: str = "full", unet_ehs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BrushNet's 28 residuals injected into the UNet -> the UNet's prediction.
    `unet_ehs` (default `ehs`) is the UNet's context: the text tokens and,
    in ip_adapter mode, the normal token after them.
    With `gradient_checkpointing` both forwards are checkpointed
    (non-reentrant `torch.utils.checkpoint`): under `policy` "full" they are
    recomputed whole in the backward pass, under "dots" all but the outputs
    of `DOT_OPS`."""
    extra = {"context_fn": _dots_context} if policy == "dots" else {}

    def run(module, *args, **kwargs):
        if gradient_checkpointing:
            return checkpoint(module, *args, use_reentrant=False, **extra, **kwargs)
        return module(*args, **kwargs)

    down, mid, up = run(brushnet, noisy, timesteps, ehs, cond)
    return run(unet, noisy, timesteps, ehs if unet_ehs is None else unet_ehs,
               down_block_add_samples=down, mid_block_add_sample=mid, up_block_add_samples=up)


def diffusion_loss(pred: torch.Tensor, target: torch.Tensor, timesteps: torch.Tensor,
                   schedule: NoiseSchedule, config: TrainConfig) -> torch.Tensor:
    """fp32 MSE, SNR-γ weighted per sample when `config.snr_gamma` is set."""
    err = (pred.float() - target) ** 2
    if config.snr_gamma is None:
        return err.mean()
    snr = compute_snr(schedule, timesteps)
    weights = torch.clamp(snr, max=config.snr_gamma)
    weights = weights / snr if config.prediction_type == "epsilon" else weights / (snr + 1.0)
    return (err.mean(dim=(1, 2, 3)) * weights).mean()


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _host_float(x: torch.Tensor, planned: float, what: str) -> float:
    """x's value on the host (a synchronisation, spanned as
    `rr.train.host_read`).  A fake tensor (the memory plan of
    `tools/aot_memory.py`) has none and gives `planned`: a plan takes the
    finite branch, clipping included."""
    if isinstance(x, FakeTensor):
        return planned
    with tracing.span("rr.train.host_read", what=what):
        return x.item()


def gradients_and_loss(params: List[nn.Parameter], loss: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """After `loss.backward()`: the parameters' gradients (zeros where none
    flowed) and the loss, both averaged across the data-parallel ranks (as
    is, in one process)."""
    with tracing.span("rr.train.all_reduce"):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        loss = loss.detach().clone()
        multihost.all_reduce_mean([*grads, loss])
    return grads, loss


@torch.no_grad()
def apply_update(state: TrainState, grads: List[torch.Tensor], config: TrainConfig,
                 schedule_fn: Callable[[int], float]) -> None:
    """Accumulate, clip, AdamW, EMA: the finite branch of the JAX step, on
    `state.params`' gradients `grads`."""
    k = config.gradient_accumulation_steps
    update = True
    if k > 1:
        if state.grad_acc is None:
            state.grad_acc = [torch.zeros_like(g) for g in grads]
        m = state.micro_step
        # running mean, as optax.MultiSteps: acc += (g - acc) / (m + 1)
        delta = torch._foreach_sub(grads, state.grad_acc)
        torch._foreach_div_(delta, float(m + 1))
        torch._foreach_add_(state.grad_acc, delta)
        state.micro_step = m + 1
        update = state.micro_step == k
        grads = state.grad_acc
    if update:
        norm = _host_float(_global_norm(grads), config.max_grad_norm, "grad_norm")
        if norm >= config.max_grad_norm:   # optax: g / ‖g‖ · max_norm
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, config.max_grad_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule_fn(state.updates)
        for p, g in zip(state.params, grads):
            p.grad = g
        state.optimizer.step()
        state.updates += 1
        if k > 1:
            state.micro_step = 0
            state.grad_acc = None
    if state.ema is not None:
        for name, module in state.trainable.items():
            ema_update(state.ema[name], dict(module.named_parameters()), state.step,
                       config.ema_decay)


def _move(module: nn.Module, device: torch.device) -> None:
    """module.to(device) unless every tensor of it is there already (the
    memory plan's fake tensors are made on the device and cannot be moved
    in place)."""
    if not all(t.device.type == device.type and device.index in (None, t.device.index)
               for t in (*module.parameters(), *module.buffers())):
        module.to(device)


def make_train_step(unet: nn.Module, brushnet: nn.Module, vae: nn.Module,
                    text_encoder: nn.Module, config: TrainConfig,
                    dtype: torch.dtype = torch.float32,
                    schedule: Optional[NoiseSchedule] = None, device=None,
                    normal_proj: Optional[nn.Module] = None):
    """-> (train_step, init_state).

    `init_state()` moves the modules to `device` (the card unless the
    caller passes "cpu"; raises where CUDA is missing), freezes the frozen
    ones and builds the optimizer and EMA.  `train_step(state, batch,
    generator, draws=None) -> (state, metrics)` with metrics `loss`,
    `grad_norm` and `nonfinite_skipped` (0-d tensors); `batch` is the
    loader's NHWC dict (`pixel_values`, `conditioning_pixel_values`, `masks`,
    `depths`, `input_ids`, ...; `normals` (B, 1, 3) in ip_adapter mode),
    numpy or tensors.  ip_adapter mode needs `normal_proj`."""
    ip_mode = config.normals_conditioning_mode == "ip_adapter"
    if ip_mode and normal_proj is None:
        raise ValueError("ip_adapter mode needs normal_proj (a NormalProjModel)")
    if config.gradient_checkpointing_policy not in ("full", "dots"):
        raise ValueError(config.gradient_checkpointing_policy)
    if config.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(config.prediction_type)
    noise_schedule = schedule or NoiseSchedule.create(
        num_train_timesteps=config.num_train_timesteps,
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        prediction_type=config.prediction_type,
    )
    shard = BatchShard(*multihost.rank_and_world())
    schedule_fn = lr_schedule(config, shard.world)
    ema_dtype = torch.bfloat16 if config.ema_dtype == "bf16" else None
    device = resolve_device(device)

    def init_state() -> TrainState:
        from reflecting_reality_tpu_torch.models.ip_adapter import ip_parameters

        for m in (unet, brushnet, vae, text_encoder) + ((normal_proj,) if ip_mode else ()):
            _move(m, device)
        trainable = {"brushnet": brushnet}
        frozen = {"vae": vae, "text": text_encoder}
        # ip mode: the UNet is trainable so its to_k_ip/to_v_ip train
        (trainable if config.train_base_unet or ip_mode else frozen)["unet"] = unet
        if ip_mode:
            trainable["normal_proj"] = normal_proj
        for m in frozen.values():
            m.requires_grad_(False)
        for m in trainable.values():
            m.requires_grad_(True)
        if ip_mode and not config.train_base_unet:
            unet.requires_grad_(False)
            for p in ip_parameters(unet):
                p.requires_grad_(True)
        params = [p for m in trainable.values() for p in m.parameters() if p.requires_grad]
        multihost.broadcast_from_main(params)
        optimizer, _ = make_optimizer(config, params, shard.world)
        ema = None
        if config.use_ema:
            ema = {k: {n: p.detach().to(ema_dtype or p.dtype, copy=True)
                       for n, p in m.named_parameters() if p.requires_grad}
                   for k, m in trainable.items()}
        return TrainState(step=0, trainable=trainable, frozen=frozen, optimizer=optimizer,
                          params=params, ema=ema)

    def autocast():
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=dtype)

    def compute_loss(state: TrainState, batch, generator, draws) -> torch.Tensor:
        with torch.no_grad(), autocast():
            latents, cond = assemble_conditioning_latents(
                vae, batch, config, generator, draws.get("vae_noise"), dtype, shard)
            ehs = text_encoder(torch.as_tensor(batch["input_ids"], device=device).long())
        latents = latents.float()
        bsz = latents.shape[0]
        noise, timesteps = draws.get("noise"), draws.get("timesteps")
        noise = (shard.randn(latents.shape, generator, device) if noise is None
                 else shard.local(noise))
        timesteps = (shard.randint(config.num_train_timesteps, bsz, generator, device)
                     if timesteps is None else shard.local(timesteps))
        noise, timesteps = noise.to(device).float(), timesteps.to(device).long()
        noisy = add_noise(noise_schedule, latents, noise, timesteps)
        model = state.trainable.get("unet", state.frozen.get("unet"))
        with autocast():
            unet_ehs = None
            if ip_mode:
                # the normal token after the text tokens, for the UNet only
                from reflecting_reality_tpu_torch.models.ip_adapter import normal_tokens

                normal = torch.as_tensor(batch["normals"], device=device).reshape(-1, 1, 3)
                tok = normal_tokens(normal, state.trainable["normal_proj"])
                unet_ehs = torch.cat([ehs, tok.to(ehs.dtype)], dim=1).to(dtype)
            pred = denoise(model, brushnet, noisy.to(dtype), timesteps, ehs.to(dtype),
                           cond.to(dtype), config.gradient_checkpointing,
                           config.gradient_checkpointing_policy, unet_ehs)
        if config.prediction_type == "epsilon":
            target = noise
        else:
            target = get_velocity(noise_schedule, latents, noise, timesteps)
        return diffusion_loss(pred, target, timesteps, noise_schedule, config)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Any]] = None):
        with tracing.span("rr.train.step", step=state.step):
            with fp32_convolutions(dtype):
                with tracing.span("rr.train.forward"):
                    loss = compute_loss(state, batch, generator, draws or {})
                with tracing.span("rr.train.backward"):
                    loss.backward()
            grads, loss = gradients_and_loss(state.params, loss)
            grad_norm = _global_norm(grads)
            finite = bool(_host_float(torch.isfinite(loss) & torch.isfinite(grad_norm), 1.0,
                                      "finite"))
            if finite:
                with tracing.span("rr.train.optimizer"):
                    apply_update(state, grads, config, schedule_fn)
            for p in state.params:
                p.grad = None
            state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "nonfinite_skipped": torch.tensor(0.0 if finite else 1.0)}
        return state, metrics

    return train_step, init_state
