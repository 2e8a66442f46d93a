"""Data parallelism of the port on the CPU: the pipeline's
`enable_data_parallel` over a mesh of two CPU entries against the port
without it and against JAX's `enable_data_parallel(make_mesh(2))`
(tests/test_pipeline.py:321-343), the sharded decode through the pipeline,
the mutual-exclusion and divisibility errors, and a two-process gloo
training step against JAX's single-process step on the same global batch
with JAX's draws passed in.

Tolerances: the pipeline's decoded float image at 1e-3 max abs against JAX
(tests/test_torch_pipeline.py), the uint8 images within 1 of the port's own
undivided call; the training step at tests/test_torch_training.py's (loss
and gradient norm rtol 1e-5, every gradient, recovered from AdamW's first
moment, at 1e-4 of the model's largest)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.parallel.mesh import make_mesh as j_make_mesh
from reflecting_reality_tpu.training.train_step import TrainConfig as JTrainConfig
from reflecting_reality_tpu.training.train_step import make_train_step as j_make_train_step
from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
from reflecting_reality_tpu_torch.tools import multiprocess_dryrun as dryrun
from tests.test_torch_deepcache import pipes, unets  # noqa: F401  (fixtures)
from tests.test_torch_helpers import randn
from tests.test_torch_pipeline import _call_kwargs
from tests.test_torch_training import (
    adam_moments, batch_of, flat, jax_draws, recover_grads, torch_draws, torch_models,
)
from tests.test_torch_training import jax_models  # noqa: F401  (fixture)
from tests.test_torch_training import STEP_CFG
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

N = 4                # images a call: two a mesh entry
CPU2 = ("cpu", "cpu")


def _kw():
    return dict(_call_kwargs(), num_inference_steps=2, num_images_per_prompt=N,
                latents=randn(11, N, 8, 8, 4))


def test_data_parallel_matches_the_port_and_jax(pipes):  # noqa: F811
    j, t = pipes
    kw = _kw()
    ref = t(**kw, output_type="latent")
    ref8 = t(**kw)
    t.enable_data_parallel(make_mesh(devices=CPU2))
    try:
        got = t(**kw, output_type="latent")
        got8 = t(**kw)
    finally:
        t.disable_data_parallel()
    assert got.shape == ref.shape == (N, 64, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got8.astype(int) - ref8.astype(int)).max() <= 1
    j.enable_data_parallel(j_make_mesh(2))
    try:
        want = np.asarray(j(**dict(kw, latents=jnp.asarray(kw["latents"])),
                            output_type="latent"))
    finally:
        j.disable_data_parallel()
    assert np.abs(got - want).max() <= 1e-3, np.abs(got - want).max()


def test_sharded_vae_through_the_pipeline(pipes):  # noqa: F811
    """enable_sharded_vae(exact=True) reproduces the plain decode (JAX
    tests/test_sharded_vae.py:111-128); disabling restores it exactly."""
    _, t = pipes
    kw = dict(_call_kwargs(), num_inference_steps=2)
    ref = t(**kw, output_type="latent")
    t.enable_sharded_vae(make_mesh(devices=CPU2))
    try:
        got = t(**kw, output_type="latent")
    finally:
        t.disable_sharded_vae()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(t(**kw, output_type="latent"), ref)


def test_exclusivity_and_divisibility_errors(pipes):  # noqa: F811
    _, t = pipes
    mesh = make_mesh(devices=CPU2)
    t.enable_data_parallel(mesh)
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            t.enable_sharded_vae(mesh)
        with pytest.raises(ValueError, match="divisible"):
            t(**dict(_kw(), num_images_per_prompt=3, latents=randn(11, 3, 8, 8, 4)))
    finally:
        t.disable_data_parallel()
    t.enable_sharded_vae(mesh)
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            t.enable_data_parallel(mesh)
    finally:
        t.disable_sharded_vae()


def test_two_process_step_matches_jax(jax_models, tmp_path):  # noqa: F811
    """Two gloo ranks, each on its 2 rows of a global batch of 4, with
    JAX's draws for the whole batch, against JAX's one-process step."""
    mods, params = jax_models
    cfg = dict(STEP_CFG, train_base_unet=True, snr_gamma=5.0)
    j_step, j_init = j_make_train_step(mods["unet"], mods["brushnet"], mods["vae"],
                                       mods["text"], JTrainConfig(**cfg))
    j_state = j_init(params["brushnet"], params["unet"], params["vae"], params["text"])
    batch = batch_of(N)
    rng = jax.random.PRNGKey(3)
    j_s1, j_m = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    inputs = str(tmp_path / "inputs.pt")
    torch.save({"state_dicts": {k: m.state_dict() for k, m in torch_models(params).items()},
                "batch": batch, "draws": torch_draws(jax_draws(rng, N)), "config": cfg},
               inputs)
    args = argparse.Namespace(out_dir=str(tmp_path), inputs=inputs)
    r0, r1 = dryrun.run_workers(args, 2)
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    np.testing.assert_allclose(r0["loss"], float(j_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], float(j_m["grad_norm"]), rtol=1e-5)
    s0, s1 = (torch.load(tmp_path / f"state_2p_{r}.pt", weights_only=True) for r in (0, 1))
    j_mu, _ = adam_moments(j_s1.opt_state)
    gn = float(j_m["grad_norm"])
    for name in ("brushnet", "unet"):
        want = recover_grads(flat(j_mu[name]), gn)
        got = recover_grads({k[len(name) + 1:]: v.numpy() for k, v in s0["exp_avg"].items()
                             if k.startswith(name + ".")}, r0["grad_norm"])
        assert sorted(got) == sorted(want)
        tol = 1e-4 * max(np.abs(g).max() for g in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    for part in ("params", "exp_avg"):
        for k in s0[part]:
            assert torch.equal(s0[part][k], s1[part][k]), (part, k)


def test_multiprocess_dryrun_launcher(tmp_path):
    """The port's tools/multiprocess_dryrun.py end to end: its five checks
    (process count, the step against one process, loader striding,
    barriers, the evaluation CSV merge)."""
    summary = dryrun.main(["--out_dir", str(tmp_path)])
    assert summary["ok"] and summary["process_count"] == 2
    assert summary["merged_ok"] and summary["n_batches_checked"] == 4
    assert abs(summary["loss_2proc"] - summary["loss_1proc"]) <= 1e-5 * summary["loss_1proc"]
    assert summary["first_moment_max_err"] <= summary["first_moment_tol"]
