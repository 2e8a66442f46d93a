"""The port's training checkpoints against the JAX package's: the folder
layout, JAX reading the port's model folders, pruning and `latest`, an exact
resume of the AdamW state, and the background writer.  Weights move without
arithmetic, so every comparison is exact."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.core.io import load_pretrained as j_load_pretrained
from reflecting_reality_tpu.core.io import torch_to_flax_params
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.training import checkpoint as j_ckpt
from reflecting_reality_tpu.training.train_step import TrainConfig as JTrainConfig
from reflecting_reality_tpu.training.train_step import make_train_step as j_make_train_step
from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step
from reflecting_reality_tpu_torch.training import checkpoint as ckpt
from tests.test_torch_training import (  # noqa: F401  (jax_models is a fixture)
    BATCH, STEP_CFG, batch_of, jax_models, torch_models,
)

VARIANTS = {"default": {}, "unet_ema": dict(train_base_unet=True, use_ema=True)}


def _port_state(jax_models, steps=1, **kw):
    tm = torch_models(jax_models[1])
    step, init = make_train_step(tm["unet"], tm["brushnet"], tm["vae"], tm["text"],
                                 TrainConfig(**STEP_CFG, **kw), device="cpu")
    state = init()
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        state, _ = step(state, batch_of(BATCH, seed=i), gen)
    return state


def _jax_state(jax_models, **kw):
    mods, params = jax_models
    _, init = j_make_train_step(mods["unet"], mods["brushnet"], mods["vae"], mods["text"],
                                JTrainConfig(**kw))
    return init(params["brushnet"], params["unet"], params["vae"], params["text"])


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_layout_matches_jax_and_jax_reads_the_folders(jax_models, tmp_path, variant):
    kw = VARIANTS[variant]
    state = _port_state(jax_models, **kw)
    path = ckpt.save_state(str(tmp_path / "port"), 3, state)
    mods = jax_models[0]
    j_path = j_ckpt.save_state(str(tmp_path / "jax"), 3, _jax_state(jax_models, **kw),
                               mods["brushnet"], mods["unet"])
    assert os.path.basename(path) == os.path.basename(j_path) == "checkpoint-3"
    port = [p for p in _tree(path) if p != ckpt.TRAIN_STATE_NAME]
    assert port == [p for p in _tree(j_path) if p != "train_state.msgpack"]
    assert ckpt.TRAIN_STATE_NAME in _tree(path)

    # the JAX loader (validated against its module's structure) reads the
    # port's folders and gets the port's weights
    folders = {"brushnet": (JBrushNet, state.trainable["brushnet"].state_dict())}
    if state.ema is not None:
        folders["ema/brushnet"] = (JBrushNet, state.ema["brushnet"])
        folders["ema/unet"] = (JUNet, state.ema["unet"])
    if "unet" in state.trainable:
        folders["unet"] = (JUNet, state.trainable["unet"].state_dict())
    for sub, (cls, sd) in folders.items():
        _, params = j_load_pretrained(cls, os.path.join(path, sub))
        want = torch_to_flax_params({k: v.numpy() for k, v in sd.items()})
        got_leaves = jax.tree_util.tree_leaves_with_path(params["params"])
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves], sub
        for (p, g), (_, w) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=f"{sub} {p}")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_save_load_round_trips_the_state_exactly(jax_models, tmp_path, accumulate):
    """AdamW moments and steps, counters, EMA and (mid-accumulation) the
    running gradient mean come back bit for bit into a fresh state."""
    kw = dict(use_ema=True, gradient_accumulation_steps=accumulate)
    state = _port_state(jax_models, steps=3, **kw)
    path = ckpt.save_state(str(tmp_path), state.step, state)
    fresh = _port_state(jax_models, steps=0, **kw)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    ckpt.load_state(path, fresh)
    assert (fresh.step, fresh.updates, fresh.micro_step) == (state.step, state.updates,
                                                             state.micro_step)
    for a, b in zip(state.params, fresh.params):
        assert torch.equal(a, b)
    for a, b in zip(state.params, fresh.params):
        sa, sb = state.optimizer.state[a], fresh.optimizer.state[b]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for n, t in state.ema["brushnet"].items():
        assert torch.equal(t, fresh.ema["brushnet"][n]), n
    if accumulate > 1:
        assert state.micro_step == 1 and fresh.grad_acc is not None
        for a, b in zip(state.grad_acc, fresh.grad_acc):
            assert torch.equal(a, b)
    else:
        assert fresh.grad_acc is None
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]


def _listing(root, steps, with_state, tmp_left):
    os.makedirs(root)
    for s in steps:
        d = os.path.join(root, f"checkpoint-{s}")
        os.makedirs(d)
        if s in with_state:
            for name in ("train_state.msgpack", ckpt.TRAIN_STATE_NAME):
                open(os.path.join(d, name), "w").close()
    if tmp_left:
        os.makedirs(os.path.join(root, "checkpoint-40.tmp"))
    open(os.path.join(root, "args.json"), "w").close()


@pytest.mark.parametrize("limit,keep,tmp_left", [
    (None, (), False), (1, (), False), (2, (), True), (3, (5,), False), (1, (5, 20), True),
    (10, (), False)])
def test_prune_and_latest_match_jax(tmp_path, limit, keep, tmp_left):
    steps, with_state = (5, 10, 20, 30), (5, 10, 20)    # checkpoint-30 lacks its state file
    for side in ("port", "jax"):
        _listing(str(tmp_path / side), steps, with_state, tmp_left)
    assert ckpt.checkpoint_steps(str(tmp_path / "port")) == j_ckpt.checkpoint_steps(
        str(tmp_path / "jax")) == list(steps)
    ckpt.prune_checkpoints(str(tmp_path / "port"), limit, keep)
    j_ckpt.prune_checkpoints(str(tmp_path / "jax"), limit, keep)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    got, want = (ckpt.latest_checkpoint(str(tmp_path / "port")),
                 j_ckpt.latest_checkpoint(str(tmp_path / "jax")))
    assert (got and os.path.basename(got)) == (want and os.path.basename(want))
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_async_checkpointer_writes_the_same_and_reraises(jax_models, tmp_path):
    state = _port_state(jax_models, steps=1, use_ema=True)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), 1, state, total_limit=1)
    before = [p.detach().clone() for p in state.params]
    for p in state.params:                   # the step mutates the modules in place
        p.data.add_(1.0)
    saver.wait()
    path = str(tmp_path / "async" / "checkpoint-1")
    assert list(saver.written) == [path] and saver.written[path] > 0
    for p, b in zip(state.params, before):
        p.data.copy_(b)
    sync = ckpt.save_state(str(tmp_path / "sync"), 1, state)
    assert _tree(path) == _tree(sync)
    for sub in ("brushnet", os.path.join("ema", "brushnet")):
        name = os.path.join(sub, "diffusion_pytorch_model.safetensors")
        assert open(os.path.join(path, name), "rb").read() == \
            open(os.path.join(sync, name), "rb").read()
    fresh = _port_state(jax_models, steps=0, use_ema=True)
    ckpt.load_state(path, fresh)
    for a, b in zip(before, fresh.params):
        assert torch.equal(a, b)

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    saver.save(str(blocker), 2, state)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                             # the error is raised once
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "async"))
    shutil.rmtree(tmp_path / "async")
