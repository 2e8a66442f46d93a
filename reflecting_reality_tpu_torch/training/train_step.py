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

The non-finite guard needs the host to see the loss and the gradient norm
(one synchronisation a step): a NaN/Inf in either leaves the parameters, the
AdamW moments, the accumulated gradients and the EMA untouched (:370-389).
`gradient_accumulation_steps = K` averages K micro-steps and updates on the
K-th, like `optax.MultiSteps`; the LR schedule counts updates, not
micro-steps.  `draws=` lets a caller pass the step's random numbers in (the
VAE posterior noise, the diffusion noise and the timesteps), so a test can
reproduce the JAX package's `jax.random` draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from reflecting_reality_tpu_torch.core.device import resolve_device
from reflecting_reality_tpu_torch.models.vae import DiagonalGaussian
from reflecting_reality_tpu_torch.schedulers.common import (
    NoiseSchedule,
    add_noise,
    compute_snr,
    get_velocity,
)
from reflecting_reality_tpu_torch.training.ema import ema_update
from reflecting_reality_tpu_torch.training.lr_schedules import get_schedule

IP_ADAPTER_TODO = ("normals_conditioning_mode='ip_adapter' is not ported yet "
                   "(ROADMAP.md queue A, item 14)")


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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is None:
        noise = torch.randn(dist.mean.shape, generator=generator, device=dist.mean.device)
    return dist.mean + dist.std * noise.to(dist.mean.device, dist.mean.dtype)


def assemble_conditioning_latents(
    vae: nn.Module, batch: Mapping[str, Any], config: TrainConfig,
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (latents, conditioning latents), NCHW, from an NHWC batch (the JAX
    version's third output, the ip_adapter normal, waits for that mode).
    The posterior draws are taken from `vae_noise` ("latents", "cond",
    "depth", "normals": NCHW noise shaped like each latent) where given, else
    from `generator`.  Cached moments are cast to `dtype` first, as the JAX
    step casts every float input to its compute dtype, so a batch uploaded
    in that dtype gives the same bits.  Call it under `no_grad` (and
    autocast for bf16)."""
    device = next(vae.parameters()).device
    vae_noise = vae_noise or {}

    def enc(key: str, img: torch.Tensor) -> torch.Tensor:
        return _sample(vae.encode(img), vae_noise.get(key), generator) * config.scaling_factor

    def from_cache(key: str, moments_key: str) -> torch.Tensor:
        dist = DiagonalGaussian.from_moments(_nchw(batch[moments_key], device).to(dtype))
        return _sample(dist, vae_noise.get(key), generator) * config.scaling_factor

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
    elif config.normals_conditioning_mode == "ip_adapter":
        raise NotImplementedError(IP_ADAPTER_TODO)
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
    `adamw`: decoupled decay p·(1 − lr·wd) and ε added to sqrt(v̂)."""
    schedule = lr_schedule(config, data_parallel_size)
    optimizer = torch.optim.AdamW(
        params, lr=schedule(0), betas=(config.adam_beta1, config.adam_beta2),
        eps=config.adam_epsilon, weight_decay=config.adam_weight_decay,
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
            policy: str = "full") -> torch.Tensor:
    """BrushNet's 28 residuals injected into the UNet -> the UNet's prediction.
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
    return run(unet, noisy, timesteps, ehs, down_block_add_samples=down,
               mid_block_add_sample=mid, up_block_add_samples=up)


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


def make_train_step(unet: nn.Module, brushnet: nn.Module, vae: nn.Module,
                    text_encoder: nn.Module, config: TrainConfig,
                    dtype: torch.dtype = torch.float32,
                    schedule: Optional[NoiseSchedule] = None, device=None):
    """-> (train_step, init_state).

    `init_state()` moves the four modules to `device` (the card unless the
    caller passes "cpu"; raises where CUDA is missing), freezes the frozen
    ones and builds the optimizer and EMA.  `train_step(state, batch,
    generator, draws=None) -> (state, metrics)` with metrics `loss`,
    `grad_norm` and `nonfinite_skipped` (0-d tensors); `batch` is the
    loader's NHWC dict (`pixel_values`, `conditioning_pixel_values`, `masks`,
    `depths`, `input_ids`, ...), numpy or tensors."""
    if config.normals_conditioning_mode == "ip_adapter":
        raise NotImplementedError(IP_ADAPTER_TODO)
    if config.gradient_checkpointing_policy not in ("full", "dots"):
        raise ValueError(config.gradient_checkpointing_policy)
    if config.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(config.prediction_type)
    noise_schedule = schedule or NoiseSchedule.create(
        num_train_timesteps=config.num_train_timesteps,
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        prediction_type=config.prediction_type,
    )
    schedule_fn = lr_schedule(config)
    ema_dtype = torch.bfloat16 if config.ema_dtype == "bf16" else None
    device = resolve_device(device)

    def init_state() -> TrainState:
        for m in (unet, brushnet, vae, text_encoder):
            m.to(device)
        trainable = {"brushnet": brushnet}
        frozen = {"vae": vae, "text": text_encoder}
        (trainable if config.train_base_unet else frozen)["unet"] = unet
        for m in frozen.values():
            m.requires_grad_(False)
        for m in trainable.values():
            m.requires_grad_(True)
        params = [p for m in trainable.values() for p in m.parameters()]
        optimizer, _ = make_optimizer(config, params)
        ema = None
        if config.use_ema:
            ema = {k: {n: p.detach().to(ema_dtype or p.dtype, copy=True)
                       for n, p in m.named_parameters()}
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
                vae, batch, config, generator, draws.get("vae_noise"), dtype)
            ehs = text_encoder(torch.as_tensor(batch["input_ids"], device=device).long())
        latents = latents.float()
        bsz = latents.shape[0]
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=device)
        timesteps = draws.get("timesteps")
        if timesteps is None:
            timesteps = torch.randint(0, config.num_train_timesteps, (bsz,),
                                      generator=generator, device=device)
        noise, timesteps = noise.to(device).float(), timesteps.to(device).long()
        noisy = add_noise(noise_schedule, latents, noise, timesteps)
        model = state.trainable.get("unet", state.frozen.get("unet"))
        with autocast():
            pred = denoise(model, brushnet, noisy.to(dtype), timesteps, ehs.to(dtype),
                           cond.to(dtype), config.gradient_checkpointing,
                           config.gradient_checkpointing_policy)
        if config.prediction_type == "epsilon":
            target = noise
        else:
            target = get_velocity(noise_schedule, latents, noise, timesteps)
        return diffusion_loss(pred, target, timesteps, noise_schedule, config)

    @torch.no_grad()
    def apply(state: TrainState, grads: List[torch.Tensor]) -> None:
        """Accumulate, clip, AdamW, EMA: the finite branch of the JAX step."""
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
            norm = _global_norm(grads).item()
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

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Any]] = None):
        loss = compute_loss(state, batch, generator, draws or {})
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
        grad_norm = _global_norm(grads)
        finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if finite:
            apply(state, grads)
        for p in state.params:
            p.grad = None
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "nonfinite_skipped": torch.tensor(0.0 if finite else 1.0)}
        return state, metrics

    return train_step, init_state
