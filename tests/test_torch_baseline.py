"""The port's SD-inpainting baseline (`baseline/sd_inpainting.py`,
`cli/train_baseline.py`, `cli/test_baseline.py`) against the JAX package's,
on the CPU in fp32, at the tiny config of tests/test_baseline.py (a 2-block
10-channel UNet, 16x16 pixels).

Tolerances:
- `baseline_in_channels`, `inflate_conv_in`: equal;
- `assemble_baseline_input` with JAX's posterior draws: 1e-5 (the fp32 VAE
  encoder, as tests/test_torch_training.py);
- one training step with JAX's draws (v-prediction, SNR-gamma 5): the loss
  rtol 1e-5; every UNet gradient (recovered from AdamW's first moment)
  within 1e-4 of the largest, as tests/test_torch_training.py argues, and
  the gradient norm at that same rtol 1e-4 (measured 1.5e-5: the whole
  UNet's backward, conv_in and the first down block carrying the largest
  sums); the parameters after the update within 1e-6 + lr*min(2, tol/|g|);
- the pipeline with JAX's initial and VAE noise, UniPC and DDIM, 2 steps:
  the decoded image within 1e-3, uint8 within 1 level (as the BrushNet
  pipeline's parity tests);
- the CLI journey (train 2 steps, sweep the checkpoints, score the sheets):
  files, sizes and finite scores.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.baseline import sd_inpainting as jb
from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.training.train_step import TrainConfig as JTrainConfig
from reflecting_reality_tpu_torch.baseline import sd_inpainting as tb
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.training import TrainConfig
from tests.test_torch_helpers import nhwc_to_nchw, port_and_jax, randn
from tests.test_torch_training import (
    BATCH, CFG, H, LR, STEP_CFG, TEXT_CFG, VAE_CFG, W, _grad_tol, _update_tol, adam_moments,
    batch_of, flat, recover_grads,
)
from tests.test_torch_helpers import one_thread_env, one_torch_thread  # noqa: F401

IN_CH = 10                       # depth concat
STEP_KW = dict(snr_gamma=5.0, prediction_type="v_prediction")


@pytest.fixture(scope="module")
def models():
    """The port's tiny 10-channel UNet, VAE and CLIP from seeds, and JAX's
    modules with the same weights."""
    unet, up = port_and_jax(UNet2DConditionModel, 0, sample_size=2, in_channels=IN_CH, **CFG)
    vae, vp = port_and_jax(AutoencoderKL, 1, **VAE_CFG)
    text, tp = port_and_jax(CLIPTextModel, 2, **TEXT_CFG)
    return dict(unet=unet, vae=vae, text=text), dict(
        unet=(JUNet(sample_size=2, in_channels=IN_CH, **CFG), up), vae=(JVAE(**VAE_CFG), vp),
        text=(JCLIP(**TEXT_CFG), tp))


@pytest.mark.parametrize("depth,normals", [(None, None), ("concat", None), ("latents", "concat"),
                                           ("concat", "latents"), (None, "concat")])
def test_in_channels_match_jax(depth, normals):
    assert tb.baseline_in_channels(depth, normals) == jb.baseline_in_channels(depth, normals)


@pytest.mark.parametrize("new_in,preserve", [(10, 4), (13, 9)])
def test_inflate_conv_in_matches_jax(new_in, preserve):
    """conv_in's (cout, cin, 3, 3) weight against JAX's HWIO inflation."""
    old_in = max(preserve, 4)
    kernel = randn(0, 3, 3, old_in, 8)
    want = jb.inflate_conv_in_params({"conv_in": {"kernel": kernel}}, (3, 3, new_in, 8),
                                     preserve=preserve)["conv_in"]["kernel"]
    got = tb.inflate_conv_in(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), new_in,
                             preserve)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))
    assert (got[:, preserve:] == 0).all()


@pytest.mark.parametrize("depth,normals", [(None, None), ("concat", "latents"),
                                           ("latents", "concat")])
def test_assemble_baseline_input_matches_jax(models, depth, normals):
    """Every depth and normals mode, mask first, with JAX's three posterior
    draws (split of its `rng`) passed in."""
    tm, jm = models
    batch = batch_of(BATCH)
    batch["normals"] = np.random.RandomState(5).randn(BATCH, H, W, 3).astype(np.float32)
    cfg = dict(depth_conditioning_mode=depth, normals_conditioning_mode=normals)
    noisy = randn(6, BATCH, 2, 2, 4)
    rng = jax.random.PRNGKey(7)
    jvae, vp = jm["vae"]
    want = jax.jit(lambda p, b, x: jb.assemble_baseline_input(jvae, p, b, x, rng,
                                                              JTrainConfig(**cfg)))(
        vp, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(noisy))
    keys = jax.random.split(rng, 3)
    noise = {k: nhwc_to_nchw(np.asarray(jax.random.normal(kk, (BATCH, 2, 2, 4), jnp.float32)))
             for k, kk in zip(("cond", "depth", "normals"), keys)}
    with torch.no_grad():
        got = tb.assemble_baseline_input(tm["vae"], batch, nhwc_to_nchw(noisy),
                                         TrainConfig(**cfg), vae_noise=noise)
    assert got.shape[1] == tb.baseline_in_channels(depth, normals)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _jax_step_draws(rng, n: int) -> dict:
    """What JAX's baseline loss_fn draws from `rng` (sd_inpainting.py:109-123
    and assemble_baseline_input :60), as the port's `draws=`."""
    r_lat, r_cond, r_noise, r_t = jax.random.split(rng, 4)
    shape = (n, 2, 2, 4)
    r1 = jax.random.split(r_cond, 3)[0]
    normal = lambda r: nhwc_to_nchw(np.asarray(jax.random.normal(r, shape, jnp.float32)))
    return {"vae_noise": {"latents": normal(r_lat), "cond": normal(r1)},
            "noise": normal(r_noise),
            "timesteps": torch.tensor(np.asarray(
                jax.random.randint(r_t, (n,), 0, 1000, dtype=jnp.int32))).long()}


def test_train_step_matches_jax(models):
    """One whole-UNet step (depth concat, v-prediction, SNR-gamma) from the
    same weights, batch and draws: loss, gradient norm, every gradient and
    every parameter after AdamW."""
    import copy

    tm, jm = models
    cfg = dict(STEP_CFG, depth_conditioning_mode="concat", **STEP_KW)
    j_step, j_init = jb.make_baseline_train_step(jm["unet"][0], jm["vae"][0], jm["text"][0],
                                                 JTrainConfig(**cfg))
    j_state = j_init(jm["unet"][1], jm["vae"][1], jm["text"][1])
    batch = batch_of(BATCH)
    rng = jax.random.PRNGKey(3)
    j_s1, j_m = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    unet = copy.deepcopy(tm["unet"])
    t_step, t_init = tb.make_baseline_train_step(unet, copy.deepcopy(tm["vae"]),
                                                 copy.deepcopy(tm["text"]),
                                                 TrainConfig(**cfg), device="cpu")
    state = t_init()
    p0 = {n: p.detach().clone() for n, p in unet.named_parameters()}
    state, t_m = t_step(state, batch, draws=_jax_step_draws(rng, BATCH))
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]), rtol=1e-5)
    gn = float(j_m["grad_norm"])
    np.testing.assert_allclose(float(t_m["grad_norm"]), gn, rtol=1e-4)
    assert state.step == 1 and sorted(state.trainable) == ["unet"]
    assert not any(p.requires_grad for m in state.frozen.values() for p in m.parameters())

    mu = flat(adam_moments(j_s1.opt_state)[0])
    j_grads = recover_grads(mu, gn)
    tol = _grad_tol(j_grads)
    t_grads = recover_grads({n: state.optimizer.state[p]["exp_avg"].numpy()
                             for n, p in unet.named_parameters()}, float(t_m["grad_norm"]))
    j_p1 = flat(j_s1.unet)
    assert sorted(t_grads) == sorted(j_grads) == sorted(j_p1)
    for n, p in unet.named_parameters():
        np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=0, atol=tol, err_msg=n)
        diff = np.abs(p.detach().numpy() - j_p1[n])
        assert (diff <= _update_tol(j_grads[n], tol)).all(), (n, diff.max())
    moved = max((p.detach() - p0[n]).abs().max().item() for n, p in unet.named_parameters())
    assert moved > 0.5 * LR


# -------------------------------------------------------------- pipeline

def _pipe_inputs():
    rng = np.random.RandomState(0)
    mask = np.zeros((H, W, 3), np.float32)
    mask[4:12, 4:12] = 1.0
    return dict(prompt="a mirror", image=rng.rand(H, W, 3).astype(np.float32), mask=mask,
                depth=rng.rand(H, W, 1).astype(np.float32), num_inference_steps=2, seed=5)


@pytest.mark.parametrize("scheduler", ["unipc", "ddim"])
def test_pipeline_matches_jax(models, scheduler):
    """The baseline pipeline against JAX's, with JAX's initial noise and VAE
    noise (its `seed`'s two keys) passed in."""
    tm, jm = models
    jpipe = jb.SDInpaintingPipeline(vae=jm["vae"], text_encoder=jm["text"],
                                    tokenizer=JHashTokenizer(vocab_size=100), unet=jm["unet"],
                                    depth_conditioning_mode="concat")
    pipe = tb.SDInpaintingPipeline(vae=tm["vae"], text_encoder=tm["text"],
                                   tokenizer=HashTokenizer(vocab_size=100), unet=tm["unet"],
                                   depth_conditioning_mode="concat", device="cpu")
    kw = dict(_pipe_inputs(), scheduler=scheduler)
    ref = np.asarray(jpipe(**kw, output_type="latent"))
    r_noise, r_vae = jax.random.split(jax.random.PRNGKey(kw["seed"]))
    noise = {"latents": np.asarray(jax.random.normal(r_noise, (1, 2, 2, 4), jnp.float32)),
             "vae_noise": np.asarray(jax.random.normal(r_vae, (1, 2, 2, 4), jnp.float32))}
    got = pipe(**kw, output_type="latent", **noise)
    assert got.shape == ref.shape == (1, H, W, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()
    got8 = pipe(**kw, **noise)
    ref8 = np.round(np.clip(ref / 2 + 0.5, 0, 1) * 255).astype(int)
    assert got8.dtype == np.uint8 and np.abs(got8.astype(int) - ref8).max() <= 1
    # the port's own draws: the same seed gives the same image
    np.testing.assert_array_equal(pipe(**kw), pipe(**kw))


@pytest.mark.parametrize("depth,normals", [("latents", None), ("concat", "concat"),
                                           (None, "latents"), ("concat", "ip_adapter")])
def test_pipeline_refuses_modes_jax_cannot_run(models, depth, normals):
    """JAX's baseline pipeline assembles the mask, the masked latents and
    depth `concat` only; the port raises for the other modes up front, and
    for a UNet whose conv_in does not take what the mode gives."""
    tm, _ = models
    with pytest.raises(ValueError, match="baseline pipeline"):
        tb.SDInpaintingPipeline(vae=tm["vae"], text_encoder=tm["text"],
                                tokenizer=HashTokenizer(vocab_size=100), unet=tm["unet"],
                                depth_conditioning_mode=depth, normals_conditioning_mode=normals,
                                device="cpu")
    with pytest.raises(ValueError, match="input channels"):
        tb.SDInpaintingPipeline(vae=tm["vae"], text_encoder=tm["text"],
                                tokenizer=HashTokenizer(vocab_size=100), unet=tm["unet"],
                                device="cpu")


# ------------------------------------------------------------------ CLIs

def test_cli_journey(tmp_path):
    """train_baseline (2 steps, the inflated 10-channel UNet written as
    checkpoint-N/unet), test_baseline --all_ckpt over the run, then
    metrics.evaluate's PSNR/SSIM over its sheets, all on the CPU."""
    pytest.importorskip("h5py")
    from reflecting_reality_tpu_torch.cli import test_baseline, train_baseline
    from reflecting_reality_tpu_torch.core.io import load_pretrained
    from reflecting_reality_tpu_torch.metrics import evaluate
    from tests.test_torch_cli import write_tiny_base
    from tests.tiny_checkpoint import make_synmirror_data

    base, data, run = (str(tmp_path / d) for d in ("base", "data", "run"))
    write_tiny_base(base)
    make_synmirror_data(data, n=4, size=64)
    common = ["--depth_conditioning_mode", "concat", "--seed", "0", "--device", "cpu",
              "--resolution", "64"]
    state = train_baseline.main([
        "--pretrained_model_name_or_path", base, "--train_data_dir", data, "--output_dir", run,
        "--logging_dir", os.path.join(run, "logs"), "--train_batch_size", "1",
        "--max_train_steps", "2", "--checkpointing_steps", "1", "--learning_rate", "1e-4",
        "--lr_warmup_steps", "0", "--report_to", "none", "--dataloader_num_workers", "1",
        *common])
    assert state.step == 2
    assert sorted(os.listdir(run)) == ["args.json", "checkpoint-1", "checkpoint-2", "logs"]
    unet = load_pretrained(UNet2DConditionModel, os.path.join(run, "checkpoint-2", "unet"))
    base_unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    assert unet.in_channels == IN_CH and base_unet.in_channels == 4
    w = unet.conv_in.weight.detach()
    assert w.shape[1] == IN_CH and not torch.equal(w[:, :4], base_unet.conv_in.weight)

    test_baseline.main(["--brushnet_path", run, "--all_ckpt", "--ckpt_modulo", "2",
                        "--base_model_path", base, "--train_data_dir", data,
                        "--num_inference_steps", "2", "--num_images_per_validation", "4",
                        *common])
    assert not os.path.exists(os.path.join(run, "checkpoint-1", "inference"))
    infer = os.path.join(run, "checkpoint-2", "inference")
    sheets = sorted(f for f in os.listdir(infer) if f.endswith(".png"))
    assert sheets == [f"uid{i}_{i}.png" for i in range(4)]
    from PIL import Image

    assert Image.open(os.path.join(infer, sheets[0])).size == (128, 128)
    evaluate.main(["--train_data_dir", data, "--csv", "test.csv", "--infer_dir", infer,
                   "--resolution", "64", "--num_images_per_validation", "4", "--mode", "calc",
                   "--metrics", "PSNR", "SSIM", "--device", "cpu"])
    import pandas as pd

    df = pd.read_csv(os.path.join(infer, "eval_0.csv"))
    assert len(df) == 4 and np.isfinite(df[["PSNR", "SSIM"]].to_numpy()).all()


# one rank of a torchrun launch of the baseline CLI; each weight write is
# recorded by the rank that made it
BASELINE_RANK = """
import json, os, sys, torch
rank, port, out, argv = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
torch.set_num_threads(1)
from reflecting_reality_tpu_torch.cli import train_baseline
from reflecting_reality_tpu_torch.core import io
save = io.save_pretrained
def recorded(module, path, *a, **k):
    with open(os.path.join(out, f"wrote_{rank}.txt"), "a") as f:
        f.write(os.path.relpath(path, out) + "\\n")
    return save(module, path, *a, **k)
io.save_pretrained = recorded
state = train_baseline.main(argv)
torch.save(state.trainable["unet"].state_dict(), os.path.join(out, f"unet_{rank}.pt"))
"""


def test_cli_two_processes_train_one_global_batch(tmp_path):
    """WORLD_SIZE=2 (refused before multi-process runs were ported): two gloo
    ranks of train_baseline under torchrun's environment, one sample each.
    Rank 0 alone writes checkpoint-N/unet, both ranks end with equal
    weights, and the losses are a one-process run's on the global batch of
    2 (rtol 1e-5)."""
    pytest.importorskip("h5py")
    import json
    import sys

    from reflecting_reality_tpu_torch.cli import train_baseline
    from reflecting_reality_tpu_torch.tools.multiprocess_dryrun import free_port, spawn
    from tests.test_torch_cli import write_tiny_base
    from tests.tiny_checkpoint import make_synmirror_data

    base, data = str(tmp_path / "base"), str(tmp_path / "data")
    write_tiny_base(base)
    make_synmirror_data(data, n=4, size=64)

    def argv(run, batch):
        return ["--pretrained_model_name_or_path", base, "--train_data_dir", data,
                "--output_dir", run, "--logging_dir", os.path.join(run, "logs"),
                "--train_batch_size", str(batch), "--max_train_steps", "2",
                "--checkpointing_steps", "2", "--learning_rate", "1e-4", "--lr_warmup_steps",
                "0", "--report_to", "none", "--dataloader_num_workers", "1", "--log_every", "1",
                "--depth_conditioning_mode", "concat", "--seed", "0", "--device", "cpu",
                "--resolution", "64"]

    def losses(run):
        with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}

    run = str(tmp_path / "ddp")
    os.makedirs(run)
    port = str(free_port())
    spawn([[sys.executable, "-c", BASELINE_RANK, str(r), port, run, json.dumps(argv(run, 1))]
           for r in range(2)], [str(tmp_path / f"rank{r}.log") for r in range(2)],
          timeout_s=120, env=one_thread_env(),
          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert open(os.path.join(run, "wrote_0.txt")).read().split() == ["checkpoint-2/unet"]
    assert not os.path.exists(os.path.join(run, "wrote_1.txt"))
    w0, w1 = (torch.load(os.path.join(run, f"unet_{r}.pt"), weights_only=True) for r in (0, 1))
    assert all(torch.equal(w0[k], w1[k]) for k in w0)

    one = str(tmp_path / "one")
    train_baseline.main(argv(one, 2))
    ddp, ref = losses(run), losses(one)
    assert sorted(ddp) == sorted(ref) == [1, 2]
    for step in ref:
        np.testing.assert_allclose(ddp[step], ref[step], rtol=1e-5)
