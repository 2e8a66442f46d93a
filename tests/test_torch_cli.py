"""The port's training CLI on the tiny checkpoint, against the JAX CLI: the
parser, the batches the step is given, the user journey (train, checkpoint,
validate, resume, load the checkpoint into the pipeline), the modes that
must not change the result (`--steps_per_dispatch`, `--device_cache`, the
bf16 transport), the non-finite abort, a two-process data-parallel run, and a
JAX-written checkpoint loaded by the port.  Batches and weights move without
arithmetic, and the modes repeat the same CPU arithmetic in the same order,
so every comparison is exact."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.cli import train as j_train
from reflecting_reality_tpu.core.io import flax_to_torch_state
from reflecting_reality_tpu.core.io import load_pretrained as j_load_pretrained
from reflecting_reality_tpu.data import loader as j_loader
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.training import train_step as j_train_step
from reflecting_reality_tpu_torch.cli import train
from reflecting_reality_tpu_torch.core.io import (
    WEIGHTS_NAME,
    empty_module,
    load_safetensors,
    save_safetensors,
)
from reflecting_reality_tpu_torch.data.tokenizer import write_byte_vocab
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from reflecting_reality_tpu_torch.tools import precompute_latents
from tests.tiny_checkpoint import TINY_TEXT, TINY_UNET, make_synmirror_data
from tests.test_torch_helpers import one_thread_env, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.integration


@pytest.fixture(scope="module", autouse=True)
def restore_jax_attention_backend():
    """The JAX CLI's `main` sets the JAX package's process-global attention
    backend ("flash" by default); put it back for the test files that run
    after this one in the same process."""
    from reflecting_reality_tpu.ops.attention import get_attention_backend, set_attention_backend

    before = get_attention_backend()
    yield
    set_attention_backend(before)

N_SAMPLES = 8


def write_tiny_base(base: str, seed: int = 0) -> str:
    """The tiny SD checkpoint of tests/tiny_checkpoint.py (same configs and
    layout), its weights drawn with numpy from a seed and written by the
    port's own writers; the JAX package reads it too.  (Initialising the JAX
    modules there costs most of a minute.)"""
    r = np.random.RandomState(seed)
    parts = (("unet", UNet2DConditionModel, TINY_UNET, WEIGHTS_NAME),
             ("vae", AutoencoderKL, dict(block_out_channels=(4, 4, 4, 4), norm_num_groups=2),
              WEIGHTS_NAME),
             ("text_encoder", CLIPTextModel, TINY_TEXT, "model.safetensors"))
    for sub, cls, cfg, weights in parts:
        module = empty_module(cls, cfg)
        state = {}
        for k, v in module.state_dict().items():
            x = 0.05 * r.standard_normal(tuple(v.shape))
            if v.dim() == 1 and "norm" in k and k.endswith("weight"):
                x += 1.0                      # norm scales near one
            state[k] = torch.from_numpy(x.astype(np.float32))
        folder = os.path.join(base, sub)
        module.save_config(folder)
        save_safetensors(state, os.path.join(folder, weights))
    write_byte_vocab(os.path.join(base, "tokenizer"))
    return base


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tiny SD checkpoint, 8 synthetic SynMirror samples at 64² and their
    moments cache (written by the port's precompute tool on the CPU)."""
    base = write_tiny_base(str(tmp_path_factory.mktemp("sd_tiny")))
    data = str(tmp_path_factory.mktemp("data"))
    cache = str(tmp_path_factory.mktemp("cache"))
    make_synmirror_data(data, n=N_SAMPLES, size=64)
    precompute_latents.main([
        "--pretrained_model_name_or_path", base, "--train_data_dir", data,
        "--output_dir", cache, "--resolution", "64", "--batch_size", "4",
        "--depth_conditioning_mode", "concat", "--save_dtype", "float16", "--device", "cpu"])
    return base, data, cache


def _argv(env, out, *extra):
    base, data, _ = env
    return ["--pretrained_model_name_or_path", base, "--train_data_dir", data,
            "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
            "--resolution", "64", "--learning_rate", "1e-3", "--lr_warmup_steps", "0",
            "--depth_conditioning_mode", "concat", "--dataloader_num_workers", "2",
            "--report_to", "none", "--validation_steps", "0", "--seed", "0",
            "--log_every", "1", *extra]


def _losses(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


def _brushnet(out, step):
    return load_safetensors(os.path.join(out, f"checkpoint-{step}", "brushnet", WEIGHTS_NAME))


@pytest.fixture(scope="module")
def jax_run(env, tmp_path_factory):
    """Three steps of the JAX CLI (8 virtual devices: global batch 8), its
    first three host batches recorded at its loader, and its checkpoints.
    Its train step is a stub that counts steps (compiling the real one costs
    about two minutes here, and test_torch_training.py holds the step's
    numbers); the CLI's loader, models, surgery, state and checkpoint writer
    run as they are."""
    out = str(tmp_path_factory.mktemp("jax_run"))
    recorded = []
    real, real_make = j_loader.prefetch_to_device, j_train_step.make_train_step

    def tee(iterator, *a, **kw):
        def record():
            for b in iterator:
                recorded.append({k: np.array(v) for k, v in b.items()})
                yield b
        return real(record(), *a, **kw)

    def make_train_step(*a, **kw):
        _, init_state = real_make(*a, **kw)

        def step(state, batch, rng):
            zero = jnp.zeros((), jnp.float32)
            return state.replace(step=state.step + 1), {"loss": zero, "grad_norm": zero}
        return step, init_state

    mp = pytest.MonkeyPatch()
    mp.setattr(j_loader, "prefetch_to_device", tee)
    mp.setattr(j_train_step, "make_train_step", make_train_step)
    try:
        j_train.main(_argv(env, out, "--train_batch_size", "1", "--max_train_steps", "3",
                           "--checkpointing_steps", "1"))
    finally:
        mp.undo()
    return out, recorded[:3]


def test_parser_keeps_every_jax_flag_and_default():
    jax_actions = {a.dest: a for a in j_train.build_parser()._actions}
    port_actions = {a.dest: a for a in train.build_parser()._actions}
    assert set(port_actions) == set(jax_actions) | {"device"}
    for dest, ja in jax_actions.items():
        pa = port_actions[dest]
        for field in ("option_strings", "default", "choices", "required", "nargs", "type",
                      "const"):
            assert getattr(pa, field) == getattr(ja, field), (dest, field)
    assert port_actions["device"].default == "cuda"


def test_batches_match_the_jax_cli(env, jax_run, tmp_path, monkeypatch):
    """The batches the port's step is given equal the JAX CLI's host batches
    for the same data and seed (three epochs of one global batch of 8)."""
    seen = []
    real = train.make_train_step

    def recording(*a, **kw):
        _, init = real(*a, **kw)

        def step(state, batch, generator):
            seen.append({k: v.clone() for k, v in batch.items()})
            state.step += 1
            zero = torch.tensor(0.0)
            return state, {"loss": zero, "grad_norm": zero, "nonfinite_skipped": zero}
        return step, init

    monkeypatch.setattr(train, "make_train_step", recording)
    train.main(_argv(env, str(tmp_path), "--train_batch_size", str(N_SAMPLES),
                     "--max_train_steps", "3", "--checkpointing_steps", "100", "--device", "cpu"))
    _, want = jax_run
    assert len(seen) == len(want) == 3
    for got, ref in zip(seen, want):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert not all(np.array_equal(want[0]["input_ids"], w["input_ids"]) for w in want[1:])


def test_user_journey_train_validate_resume_infer(env, tmp_path):
    base, _, _ = env
    out = str(tmp_path / "run")
    argv = _argv(env, out, "--train_batch_size", "1", "--max_train_steps", "2",
                 "--checkpointing_steps", "1", "--checkpoints_total_limit", "2",
                 "--num_validation_images", "1", "--num_images_per_validation", "2",
                 "--num_inference_steps", "2", "--device", "cpu")
    argv[argv.index("--validation_steps") + 1] = "2"
    train.main(argv)
    val_dir = os.path.join(out, "validation", "step-2")
    assert os.listdir(val_dir) == ["uid0.png"]
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    val = [r for r in rows if "val/psnr" in r]
    assert val and np.isfinite(val[-1]["val/psnr"]) and np.isfinite(val[-1]["val/ssim"])
    ckpt2 = os.path.join(out, "checkpoint-2")
    assert sorted(os.listdir(ckpt2)) == ["brushnet", "train_state.pt"]
    assert sorted(os.listdir(os.path.join(ckpt2, "brushnet"))) == ["config.json", WEIGHTS_NAME]
    assert json.load(open(os.path.join(out, "args.json")))["max_train_steps"] == 2

    argv[argv.index("--validation_steps") + 1] = "0"
    train.main(argv + ["--resume_from_checkpoint", "latest", "--max_train_steps", "3"])
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) == [
        "checkpoint-2", "checkpoint-3"]
    assert sorted(_losses(out)) == [1, 2, 3]

    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        base, os.path.join(ckpt2, "brushnet"), depth_conditioning_mode="concat", device="cpu")
    saved = _brushnet(out, 2)
    for k, v in pipe.brushnet.state_dict().items():
        assert torch.equal(v, saved[k]), k
    r = np.random.RandomState(0)
    img = pipe("a mirror", r.rand(64, 64, 3).astype(np.float32), np.ones((64, 64, 3), np.float32),
               depth=r.rand(64, 64, 1).astype(np.float32), num_inference_steps=2, seed=0)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_modes_give_the_same_training(env, tmp_path, precision):
    """From the moments cache: K = 2 steps per upload, the device-resident
    cache and (under bf16) an fp32 transport all give the K = 1 host-cache
    run's losses and weights, bit for bit."""
    _, _, cache = env
    runs = {"host": (), "k2": ("--steps_per_dispatch", "2"), "device_cache": ("--device_cache",),
            "device_cache_k2": ("--device_cache", "--steps_per_dispatch", "2")}
    if precision == "bf16":
        runs = {"host": (), "device_cache": ("--device_cache",),
                "fp32_transport": ("--input_transport_dtype", "fp32")}
    got = {}
    for name, extra in runs.items():
        out = str(tmp_path / name)
        train.main(_argv(env, out, "--train_batch_size", "2", "--max_train_steps", "5",
                         "--checkpointing_steps", "100", "--precomputed_latents_dir", cache,
                         "--mixed_precision", precision, "--device", "cpu", *extra))
        got[name] = (_losses(out), _brushnet(out, 5))
    ref_losses, ref_w = got.pop("host")
    assert sorted(ref_losses) == [1, 2, 3, 4, 5] and all(np.isfinite(list(ref_losses.values())))
    for name, (losses, w) in got.items():
        assert losses == ref_losses, name
        for k in ref_w:
            assert torch.equal(w[k], ref_w[k]), (name, k)


def test_attention_backend_xla_trains_the_plain_path(env, tmp_path, monkeypatch):
    """`--attention_backend xla` (refused on the card before it was ported)
    reaches every attention of the UNet, BrushNet and VAE the step trains,
    and on the CPU, where both backends take the plain path (JAX's einsum
    path, the one tests/test_torch_training.py holds the step against),
    gives the default run's losses and weights bit for bit."""
    from reflecting_reality_tpu_torch.ops.attention import Attention

    _, _, cache = env
    seen = []
    real = train.make_train_step

    def recording(unet, brushnet, vae, *a, **kw):
        seen.append({m.attention_backend for mod in (unet, brushnet, vae)
                     for m in mod.modules() if isinstance(m, Attention)})
        return real(unet, brushnet, vae, *a, **kw)

    monkeypatch.setattr(train, "make_train_step", recording)
    got = {}
    for backend in ("flash", "xla"):
        out = str(tmp_path / backend)
        train.main(_argv(env, out, "--train_batch_size", "2", "--max_train_steps", "2",
                         "--checkpointing_steps", "100", "--precomputed_latents_dir", cache,
                         "--attention_backend", backend, "--device", "cpu"))
        got[backend] = (_losses(out), _brushnet(out, 2))
    assert seen == [{"flash"}, {"xla"}]
    assert got["xla"][0] == got["flash"][0] and sorted(got["xla"][0]) == [1, 2]
    for k, w in got["flash"][1].items():
        assert torch.equal(got["xla"][1][k], w), k


def test_nonfinite_loss_saves_and_aborts(tmp_path):
    import h5py

    base, data = write_tiny_base(str(tmp_path / "base")), str(tmp_path / "data")
    make_synmirror_data(data, n=4, size=64)
    for i in range(4):
        with h5py.File(os.path.join(data, f"obj/{i}.hdf5"), "r+") as f:
            d = np.array(f["depth"])
            d[:] = np.nan
            del f["depth"]
            f["depth"] = d
    out = str(tmp_path / "run")
    with pytest.raises(FloatingPointError, match="non-finite"):
        train.main(_argv((base, data, None), out, "--train_batch_size", "1",
                         "--max_train_steps", "50", "--checkpointing_steps", "100",
                         "--max_nonfinite_steps", "2", "--device", "cpu"))
    ckpts = [d for d in os.listdir(out) if d.startswith("checkpoint-")]
    assert ckpts == ["checkpoint-2"]
    for k, v in _brushnet(out, 2).items():      # the step's guard skipped every update
        assert torch.isfinite(v).all(), k


def _validate_once(env, out, *extra):
    """One training step, then validation of one row at one seed, 2 steps."""
    argv = _argv(env, out, "--train_batch_size", "1", "--max_train_steps", "1",
                 "--checkpointing_steps", "100", "--num_validation_images", "1",
                 "--num_images_per_validation", "1", "--num_inference_steps", "2",
                 "--device", "cpu", *extra)
    argv[argv.index("--validation_steps") + 1] = "1"
    train.main(argv)
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "val/psnr" in r]


@pytest.mark.parametrize("depth_mode,normals_mode", [
    ("latents", None), ("concat", "concat"), ("concat", "latents")])
def test_validation_runs_in_every_conditioning_mode(env, tmp_path, depth_mode, normals_mode):
    """Depth `latents` and normals `concat`/`latents` train and validate:
    the pipeline takes the modes and validation passes the normals."""
    out = str(tmp_path / "run")
    extra = ["--normals_conditioning_mode", normals_mode] if normals_mode else []
    argv_mode = ["--depth_conditioning_mode", depth_mode, *extra]
    val = _validate_once(env, out, *argv_mode)
    assert os.listdir(os.path.join(out, "validation", "step-1")) == ["uid0.png"]
    assert val and np.isfinite(val[-1]["val/psnr"]) and np.isfinite(val[-1]["val/ssim"])


def test_validation_lpips(env, tmp_path):
    """--lpips_weights (a .npz in the JAX package's layout) gives val/lpips."""
    from reflecting_reality_tpu_torch.metrics.lpips import LPIPS, save_lpips_npz

    torch.manual_seed(0)
    weights = str(tmp_path / "lpips.npz")
    save_lpips_npz({k: v.abs() for k, v in LPIPS().state_dict().items()}, weights)
    val = _validate_once(env, str(tmp_path / "run"), "--lpips_weights", weights)
    assert val and np.isfinite(val[-1]["val/lpips"]) and val[-1]["val/lpips"] > 0


def test_validation_summarizer(env, tmp_path, monkeypatch):
    """--summarizer shortens the validation prompt before the pipeline sees
    it (transformers blocked: the summarizer falls back to its first 50
    words, deterministically and without a network)."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    prompts = []
    real = StableDiffusionBrushNetPipeline.__call__

    def recording(self, prompt, *a, **kw):
        prompts.append(prompt)
        return real(self, prompt, *a, **kw)

    monkeypatch.setattr(StableDiffusionBrushNetPipeline, "__call__", recording)
    long_prefix = " ".join(f"w{i}" for i in range(60)) + " "
    _validate_once(env, str(tmp_path / "run"), "--summarizer", "sshleifer/distilbart-cnn-6-6",
                   "--mirror_prompt", long_prefix)
    assert prompts == [" ".join(f"w{i}" for i in range(50))]


def test_ip_adapter_mode_trains_validates_resumes_and_loads(env, tmp_path):
    """Normals ip_adapter through the CLI (it raised before the mode was
    ported): one step with validation (the mean mirror normal reaches the
    pipeline), checkpoint-1 holds unet/ and ip_adapter/normal_proj, only the
    UNet's to_k_ip/to_v_ip differ from the base folder (they started as
    to_k/to_v copies), a resume runs to step 2, and the pipeline loads the
    checkpoint in ip mode and generates."""
    from reflecting_reality_tpu_torch.models.ip_adapter import NORMAL_PROJ_FILE, is_ip_param_name

    base, _, _ = env
    out = str(tmp_path / "run")
    ip = ("--normals_conditioning_mode", "ip_adapter", "--ip_adapter_scale", "0.7")
    val = _validate_once(env, out, "--checkpointing_steps", "1", *ip)
    assert val and np.isfinite(val[-1]["val/psnr"])
    ckpt1 = os.path.join(out, "checkpoint-1")
    assert os.path.isfile(os.path.join(ckpt1, NORMAL_PROJ_FILE))
    trained = load_safetensors(os.path.join(ckpt1, "unet", WEIGHTS_NAME))
    base_unet = load_safetensors(os.path.join(base, "unet", WEIGHTS_NAME))
    ip_keys = [k for k in trained if is_ip_param_name(k)]
    assert ip_keys and sorted(set(trained) - set(ip_keys)) == sorted(base_unet)
    for k, v in trained.items():
        if k in base_unet:
            assert torch.equal(v, base_unet[k]), k
        else:
            twin = base_unet[k.replace("_ip.", ".")]
            assert v.shape == twin.shape and not torch.equal(v, twin), k

    argv = _argv(env, out, "--train_batch_size", "1", "--max_train_steps", "2",
                 "--resume_from_checkpoint", "latest", "--device", "cpu", *ip)
    state = train.main(argv)
    assert state.step == 2 and np.isfinite(_losses(out)[2])
    assert sorted(state.trainable) == ["brushnet", "normal_proj", "unet"]

    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        base, os.path.join(ckpt1, "brushnet"), unet_path=os.path.join(ckpt1, "unet"),
        depth_conditioning_mode="concat", normals_conditioning_mode="ip_adapter",
        ip_adapter_scale=0.7, device="cpu")
    assert pipe.unet.ip_scale == 0.7 and pipe.normal_proj is not None
    rng = np.random.RandomState(0)
    img = pipe("a mirror", rng.rand(64, 64, 3).astype(np.float32),
               np.ones((64, 64, 3), np.float32), depth=rng.rand(64, 64, 1).astype(np.float32),
               normals=np.array([[0.0, 0.6, 0.8]], np.float32), num_inference_steps=2)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8


# one rank of a torchrun launch: the launcher's environment, then the CLI;
# each checkpoint write is recorded by the rank that made it
TRAIN_RANK = """
import json, os, sys, torch
rank, port, out, argv = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
torch.set_num_threads(1)
from reflecting_reality_tpu_torch.cli import train
from reflecting_reality_tpu_torch.training import checkpoint
write = checkpoint.write_state
def recorded(output_dir, step, *a, **k):
    with open(os.path.join(out, f"wrote_{rank}.txt"), "a") as f:
        f.write(f"{step}\\n")
    return write(output_dir, step, *a, **k)
checkpoint.write_state = recorded
state = train.main(argv)
torch.save(state.trainable["brushnet"].state_dict(), os.path.join(out, f"brushnet_{rank}.pt"))
"""


def test_two_processes_train_one_global_batch(env, tmp_path):
    """WORLD_SIZE=2 (refused before multi-process runs were ported): two
    gloo ranks of the CLI under torchrun's environment on the CPU, one
    sample each, `--async_save` for the periodic checkpoint.  Rank 0 alone
    writes the checkpoints and the metrics, both
    ranks end with equal weights, and the losses are a one-process run's on
    the global batch of 2 (the same rows and draws; rtol 1e-5)."""
    from reflecting_reality_tpu_torch.tools.multiprocess_dryrun import free_port, spawn

    out = str(tmp_path / "ddp")
    os.makedirs(out)
    argv = _argv(env, out, "--train_batch_size", "1", "--max_train_steps", "2",
                 "--checkpointing_steps", "1", "--async_save", "--device", "cpu")
    port = str(free_port())
    spawn([[sys.executable, "-c", TRAIN_RANK, str(r), port, out, json.dumps(argv)]
           for r in range(2)], [str(tmp_path / f"rank{r}.log") for r in range(2)],
          timeout_s=120, env=one_thread_env(),
          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert open(os.path.join(out, "wrote_0.txt")).read().split() == ["1", "2"]
    assert not os.path.exists(os.path.join(out, "wrote_1.txt"))
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    w0, w1 = (torch.load(os.path.join(out, f"brushnet_{r}.pt"), weights_only=True)
              for r in range(2))
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    for k, v in _brushnet(out, 2).items():
        assert torch.equal(v, w0[k]), k
    ddp = _losses(out)

    one = str(tmp_path / "one")
    train.main(_argv(env, one, "--train_batch_size", "2", "--max_train_steps", "2",
                     "--checkpointing_steps", "1", "--device", "cpu"))
    ref = _losses(one)
    assert sorted(ddp) == sorted(ref) == [1, 2]
    for step in ref:
        np.testing.assert_allclose(ddp[step], ref[step], rtol=1e-5)


def test_entry_point_defaults_to_the_card(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(_argv(env, str(tmp_path)))


def test_port_loads_a_jax_cli_checkpoint(env, jax_run):
    base, _, _ = env
    out, _ = jax_run
    folder = os.path.join(out, "checkpoint-1", "brushnet")
    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        base, folder, depth_conditioning_mode="concat", device="cpu")
    _, params = j_load_pretrained(JBrushNet, folder)
    want = flax_to_torch_state(jax.tree_util.tree_map(np.asarray, params["params"]))
    got = pipe.brushnet.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
