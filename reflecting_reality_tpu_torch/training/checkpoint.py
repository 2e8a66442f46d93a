"""Training checkpoints in the reference folder layout, the port's
counterpart of `reflecting_reality_tpu/training/checkpoint.py` (reference:
train_brushnet_mirror.py:997-1069 save/load hooks, :1473-1498 pruning).

Layout per step N:
    checkpoint-N/
        brushnet/{config.json, diffusion_pytorch_model.safetensors}
        unet/...            (iff train_base_unet)
        ema/brushnet/...    (iff use_ema; ema/unet too with train_base_unet)
        train_state.pt      (AdamW state_dict, step, updates, micro_step and,
                             when accumulating, the running gradient mean)

The model folders are written by `core.io.save_pretrained`, so the JAX
package's `load_pretrained` (and the reference's `from_pretrained`) read
them.  The JAX package keeps its optimizer state in `train_state.msgpack`, a
flax msgpack of an optax tree; the port's AdamW state is a torch
`state_dict`, written with `torch.save`, and `latest_checkpoint` keys on it
as the JAX one keys on its own file.

A checkpoint is written into `checkpoint-N.tmp` and renamed when complete,
so a crash leaves no directory that `latest_checkpoint` would pick.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from reflecting_reality_tpu_torch.core.io import (
    WEIGHTS_NAME,
    load_into,
    load_safetensors,
    save_pretrained,
)

TRAIN_STATE_NAME = "train_state.pt"
_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def checkpoint_steps(output_dir: str) -> List[int]:
    if not os.path.isdir(output_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(output_dir)) if m)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest `checkpoint-N` that holds a train-state file, or None."""
    for s in reversed(checkpoint_steps(output_dir)):
        path = os.path.join(output_dir, f"checkpoint-{s}")
        if os.path.isfile(os.path.join(path, TRAIN_STATE_NAME)):
            return path
    return None


def prune_checkpoints(output_dir: str, total_limit: Optional[int], keep: Iterable[int] = ()
                      ) -> None:
    """Remove the oldest checkpoints so that one more fits in `total_limit`
    (the reference prunes before saving); steps in `keep` are never removed."""
    if not total_limit:
        return
    keep = set(keep)
    steps = [s for s in checkpoint_steps(output_dir) if s not in keep]
    excess = len(steps) - (total_limit - 1)
    for s in steps[:max(excess, 0)]:
        shutil.rmtree(os.path.join(output_dir, f"checkpoint-{s}"), ignore_errors=True)


class _HostCopier:
    """Copies device tensors to host memory: with `pinned` (a dict reused
    across snapshots) into pinned buffers with non-blocking copies, which the
    caller completes with one synchronise; otherwise plain copies."""

    def __init__(self, pinned: Optional[Dict[Any, torch.Tensor]] = None):
        self.pinned = pinned
        self.async_copies = False

    def __call__(self, key, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if self.pinned is None or not t.is_cuda:
            return t.to("cpu", copy=True)
        buf = self.pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self.pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        self.async_copies = True
        return buf


def _copy_tree(tree, copy, key=()):
    if isinstance(tree, torch.Tensor):
        return copy(key, tree)
    if isinstance(tree, dict):
        return {k: _copy_tree(v, copy, key + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v, copy, key + (i,)) for i, v in enumerate(tree))
    return tree


class Snapshot:
    """Host copy of what a checkpoint writes: the trainable modules' weights,
    the EMA, the optimizer state and the counters.  The frozen modules come
    from the base folder on resume and are not copied."""

    def __init__(self, state, pinned: Optional[Dict[Any, torch.Tensor]] = None):
        copy = _HostCopier(pinned)
        self.modules = dict(state.trainable)
        self.weights = {name: _copy_tree(dict(m.state_dict()), copy, ("w", name))
                        for name, m in self.modules.items()}
        self.ema = None if state.ema is None else _copy_tree(state.ema, copy, ("ema",))
        self.train_state = {
            "step": state.step, "updates": state.updates, "micro_step": state.micro_step,
            "optimizer": _copy_tree(state.optimizer.state_dict(), copy, ("opt",)),
            "grad_acc": None if state.grad_acc is None
            else _copy_tree(list(state.grad_acc), copy, ("acc",)),
        }
        if copy.async_copies:
            torch.cuda.synchronize()


def save_state(output_dir: str, step: int, state, total_limit: Optional[int] = None,
               keep: Iterable[int] = ()) -> str:
    """Write `state` (a TrainState or a Snapshot of one) as
    `output_dir/checkpoint-<step>` and return its path."""
    prune_checkpoints(output_dir, total_limit, keep)
    final = os.path.join(output_dir, f"checkpoint-{step}")
    path = final + ".tmp"
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    snap = state if isinstance(state, Snapshot) else Snapshot(state)
    for name, module in snap.modules.items():
        save_pretrained(module, os.path.join(path, name), snap.weights[name])
    for name, shadow in (snap.ema or {}).items():
        save_pretrained(snap.modules[name], os.path.join(path, "ema", name), shadow)
    torch.save(snap.train_state, os.path.join(path, TRAIN_STATE_NAME))
    shutil.rmtree(final, ignore_errors=True)      # a re-save of the same step
    os.rename(path, final)
    return final


class AsyncCheckpointer:
    """Checkpoint writes in a background thread (`--async_save`).

    `save` copies what the checkpoint holds into pinned host buffers with
    non-blocking device-to-host copies and one synchronise before it
    returns (the step updates the modules in place), then writes from a
    thread.  At most one save is in flight: the next `save` or `wait` joins
    it first, and an exception of the write re-raises there.  The pinned
    buffers are kept and reused by the next save.  `written` maps each
    completed save's path to the seconds its write took."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[Any, torch.Tensor] = {}
        self.written: Dict[str, float] = {}

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, output_dir: str, step: int, state, total_limit: Optional[int] = None,
             keep: Iterable[int] = ()) -> None:
        self.wait()
        snap = Snapshot(state, pinned=self._pinned)
        keep = tuple(keep)

        def run():
            try:
                t0 = time.perf_counter()
                path = save_state(output_dir, step, snap, total_limit=total_limit, keep=keep)
                self.written[path] = time.perf_counter() - t0
            except BaseException as e:  # re-raised by the next wait() or save()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True, name="checkpoint-writer")
        self._thread.start()


def _load_module(module, folder: str) -> None:
    load_into(module, load_safetensors(os.path.join(folder, WEIGHTS_NAME)), where=folder)


@torch.no_grad()
def load_state(path: str, state):
    """Restore `checkpoint-N` into `state` in place (exact resume): the
    trainable modules' weights, the EMA, the optimizer state and the
    counters.  Returns `state`."""
    for name, module in state.trainable.items():
        folder = os.path.join(path, name)
        if name == "brushnet" or os.path.isdir(folder):
            _load_module(module, folder)
    if state.ema is not None:
        for name, shadow in state.ema.items():
            folder = os.path.join(path, "ema", name)
            if os.path.isdir(folder):
                saved = load_safetensors(os.path.join(folder, WEIGHTS_NAME))
                if set(saved) != set(shadow):
                    raise ValueError(f"{folder}: EMA keys differ from the module's")
                for k, t in shadow.items():
                    t.copy_(saved[k])
    blob = torch.load(os.path.join(path, TRAIN_STATE_NAME), map_location="cpu",
                      weights_only=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step, state.updates, state.micro_step = (blob["step"], blob["updates"],
                                                   blob["micro_step"])
    state.grad_acc = None if blob["grad_acc"] is None else [
        g.to(p.device) for g, p in zip(blob["grad_acc"], state.params)]
    return state
