"""The port's inference CLI (`cli/test.py`) against the JAX CLI, on the CPU.

Row handling: one recording stub `generate`/`finalize` goes into both
packages' `drive_rows` over the same HDF5 folder and the same
`--image_mode` folder: the prompts, images, masks, depth and normals each
row hands to the model, the output names, grid sizes and PNG bytes (under
`--blended` too), and the rows a skip-existing restart leaves out must be
equal.  Row selection (`--num_samples`, `--infer_list`, `--all_ckpt
--ckpt_modulo`) is held against JAX's `main` with `run_inference` stubbed.
Everything here moves data without arithmetic, so every comparison is
exact.  Then the port's own journey on the tiny checkpoint: train two
steps, sweep the checkpoints, EMA weights, batched seeds, a restart that
writes nothing, and the options still to port."""

import os
import sys
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from reflecting_reality_tpu.cli import test as j_test
from reflecting_reality_tpu_torch.cli import test as t_test
from reflecting_reality_tpu_torch.cli import train
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_cli import write_tiny_base
from tests.tiny_checkpoint import make_synmirror_data

pytestmark = pytest.mark.integration

N_ROWS = 4
SIZE = 64


def write_image_mode_data(root: str, n: int, size: int, seed: int = 0) -> None:
    """An MSD-style `--image_mode` folder: images/*.png, masks/*.png,
    depth/*.npz (key "depth") and a test.csv, drawn from a seed."""
    rng = np.random.RandomState(seed)
    for sub in ("images", "masks", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = []
    for i in range(n):
        mask = np.zeros((size, size), np.uint8)
        mask[size // 4: 3 * size // 4, size // 3: 2 * size // 3] = 255
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
            os.path.join(root, "images", f"{i}.png"))
        Image.fromarray(mask).save(os.path.join(root, "masks", f"{i}.png"))
        np.savez(os.path.join(root, "depth", f"{i}.npz"),
                 depth=(rng.rand(size, size) * 5).astype(np.float32))
        rows.append({"uid": f"msd{i}", "path": f"{i}.png",
                     "auto_caption": f"a framed mirror, scene {i}"})
    pd.DataFrame(rows).to_csv(os.path.join(root, "test.csv"), index=False)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    hdf5 = str(tmp_path_factory.mktemp("hdf5"))
    make_synmirror_data(hdf5, n=N_ROWS, size=SIZE)
    msd = str(tmp_path_factory.mktemp("msd"))
    write_image_mode_data(msd, N_ROWS, SIZE)
    return {"hdf5": hdf5, "msd": msd}


class Recorder:
    """A stand-in for the model: records what each row hands it and returns
    seeded images (from the prompt) as a handle's images."""

    def __init__(self, n):
        self.n, self.calls = n, []

    def generate(self, prompt, image, mask, depth, normals):
        self.calls.append((prompt, np.asarray(image), np.asarray(mask),
                           None if depth is None else np.asarray(depth),
                           None if normals is None else np.asarray(normals)))
        return prompt

    def finalize(self, handle):
        rng = np.random.RandomState(zlib.crc32(handle.encode()))
        return [Image.fromarray(rng.randint(0, 256, (SIZE, SIZE, 3), np.uint8))
                for _ in range(self.n)]


CASES = {
    "hdf5_depth_normals_concat": ("hdf5", ["--depth_conditioning_mode", "concat",
                                           "--normals_conditioning_mode", "concat"]),
    "hdf5_blended_latents_summarized": ("hdf5", ["--blended", "--depth_conditioning_mode",
                                                 "latents", "--normals_conditioning_mode",
                                                 "latents", "--summarizer", "distilbart",
                                                 "--mirror_prompt", "w " * 60]),
    "hdf5_ip_adapter_normals": ("hdf5", ["--normals_conditioning_mode", "ip_adapter"]),
    "msd_depth": ("msd", ["--image_mode", "--depth_conditioning_mode", "concat"]),
    "msd_blended": ("msd", ["--image_mode", "--blended", "--num_images_per_validation", "2"]),
}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_drive_rows_matches_jax(folders, tmp_path, monkeypatch, case, overlap):
    monkeypatch.setitem(sys.modules, "transformers", None)      # truncating summarizer
    kind, extra = CASES[case]
    argv = ["--brushnet_path", "unused", "--train_data_dir", folders[kind],
            "--resolution", str(SIZE), *extra]
    df = pd.read_csv(os.path.join(folders[kind], "test.csv"))
    got = {}
    for name, mod in (("jax", j_test), ("port", t_test)):
        args = mod.build_parser().parse_args(argv)
        out = str(tmp_path / name)
        os.makedirs(out)
        # a restart: the second row's sheet is already there
        kept = ("msd1.png" if kind == "msd" else "uid1_1.png")
        with open(os.path.join(out, kept), "wb") as f:
            f.write(b"earlier run")
        rec = Recorder(args.num_images_per_validation)
        if overlap:
            mod.drive_rows(args, df, out, rec.generate, rec.finalize)
        else:
            mod.drive_rows(args, df, out, lambda *a: rec.finalize(rec.generate(*a)))
        files = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
        got[name] = (rec.calls, files)
    (jcalls, jfiles), (tcalls, tfiles) = got["jax"], got["port"]
    assert len(tcalls) == len(jcalls) == N_ROWS - 1
    for jc, tc in zip(jcalls, tcalls):
        assert tc[0] == jc[0]
        for a, b in zip(tc[1:], jc[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert tfiles == jfiles and len(tfiles) == N_ROWS
    n = 2 if "2" in extra else 4
    for f, data in tfiles.items():
        if data != b"earlier run":
            assert Image.open(os.path.join(tmp_path / "port", f)).size == (
                SIZE * (n // 2), SIZE * 2)
    if "--summarizer" in extra:
        assert all(len(c[0].split()) == 50 for c in tcalls)


SELECTIONS = {
    "num_samples": lambda root: ["--num_samples", "2", "--seed", "3"],
    "infer_list": lambda root: ["--infer_list", os.path.join(root, "list.txt"),
                                "--num_samples", "1"],
    "all_ckpt_modulo": lambda root: ["--all_ckpt", "--ckpt_modulo", "2"],
    "all_ckpt": lambda root: ["--all_ckpt", "--output_dir", os.path.join(root, "out")],
    "brushnet_subfolder": lambda root: [],
}


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_row_and_checkpoint_selection_matches_jax(folders, tmp_path, monkeypatch, selection):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        os.makedirs(os.path.join(root, "run", f"checkpoint-{s}", "brushnet"))
    os.makedirs(os.path.join(root, "run", "brushnet"))
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("obj/3.hdf5\nobj/1.hdf5\n")
    argv = ["--brushnet_path", os.path.join(root, "run"), "--train_data_dir", folders["hdf5"],
            *SELECTIONS[selection](root)]
    got = {}
    for name, mod, extra in (("jax", j_test, ["--attention_backend", "xla"]),
                             ("port", t_test, ["--device", "cpu"])):
        seen = []
        monkeypatch.setattr(mod, "run_inference", lambda args, path, out, df: seen.append(
            (os.path.relpath(path, root), os.path.relpath(out, root), list(df["uid"]))))
        mod.main(argv + extra)
        got[name] = seen
    assert got["port"] == got["jax"] and got["port"]


def test_parser_keeps_every_jax_flag_and_default():
    jax_actions = {a.dest: a for a in j_test.build_parser()._actions}
    port_actions = {a.dest: a for a in t_test.build_parser()._actions}
    assert set(port_actions) == set(jax_actions) | {"device"}
    for dest, ja in jax_actions.items():
        for field in ("option_strings", "default", "choices", "required", "nargs", "type",
                      "const"):
            assert getattr(port_actions[dest], field) == getattr(ja, field), (dest, field)
    assert port_actions["device"].default == "cuda"


# ------------------------------------------------------------- journey

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny base, 2 SynMirror rows and a 2-step CPU training run with
    EMA, checkpoints at steps 1 and 2."""
    root = tmp_path_factory.mktemp("journey")
    base, data, out = (str(root / d) for d in ("base", "data", "run"))
    write_tiny_base(base)
    make_synmirror_data(data, n=2, size=SIZE)
    train.main(["--pretrained_model_name_or_path", base, "--train_data_dir", data,
                "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
                "--resolution", str(SIZE), "--train_batch_size", "1", "--max_train_steps", "2",
                "--checkpointing_steps", "1", "--learning_rate", "1e-3", "--lr_warmup_steps",
                "0", "--depth_conditioning_mode", "concat", "--use_ema", "--report_to", "none",
                "--validation_steps", "0", "--seed", "0", "--device", "cpu"])
    return base, data, out


def _infer_argv(trained, *extra):
    base, data, _ = trained
    return ["--base_model_path", base, "--train_data_dir", data, "--resolution", str(SIZE),
            "--num_inference_steps", "2", "--num_images_per_validation", "2",
            "--depth_conditioning_mode", "concat", "--device", "cpu", *extra]


def test_journey_checkpoint_sweep_ema_batched_seeds_restart(trained, tmp_path, monkeypatch):
    _, _, out = trained
    loaded, calls = [], []
    real_load, real_call = (StableDiffusionBrushNetPipeline.from_pretrained.__func__,
                            StableDiffusionBrushNetPipeline.__call__)

    def load(cls, base, brushnet_path, **kw):
        loaded.append(os.path.relpath(brushnet_path, out))
        return real_load(cls, base, brushnet_path, **kw)

    def call(self, *a, **kw):
        calls.append(kw.get("num_images_per_prompt", 1))
        return real_call(self, *a, **kw)

    monkeypatch.setattr(StableDiffusionBrushNetPipeline, "from_pretrained", classmethod(load))
    monkeypatch.setattr(StableDiffusionBrushNetPipeline, "__call__", call)
    sweep = _infer_argv(trained, "--brushnet_path", out, "--all_ckpt", "--ckpt_modulo", "2")
    t_test.main(sweep)
    assert loaded == ["checkpoint-2/brushnet"] and calls == [1, 1, 1, 1]
    assert not os.path.exists(os.path.join(out, "checkpoint-1", "inference"))
    sheets_dir = os.path.join(out, "checkpoint-2", "inference")
    assert sorted(os.listdir(sheets_dir)) == ["uid0_0.png", "uid1_1.png"]
    for f in os.listdir(sheets_dir):
        im = np.asarray(Image.open(os.path.join(sheets_dir, f)))
        assert im.shape == (2 * SIZE, SIZE, 3) and im.std() > 0

    ema_out = str(tmp_path / "ema")
    t_test.main(_infer_argv(trained, "--brushnet_path", os.path.join(out, "checkpoint-2"),
                            "--use_ema", "--batch_seeds", "--output_dir", ema_out))
    assert loaded[-1] == "checkpoint-2/ema/brushnet" and calls[-2:] == [2, 2]
    assert sorted(os.listdir(ema_out)) == ["uid0_0.png", "uid1_1.png"]

    before = {f: os.path.getmtime(os.path.join(sheets_dir, f)) for f in os.listdir(sheets_dir)}
    n_calls = len(calls)
    t_test.main(sweep)                                      # a restart: nothing to do
    assert len(calls) == n_calls
    assert {f: os.path.getmtime(os.path.join(sheets_dir, f)) for f in before} == before


@pytest.mark.parametrize("extra,item", [
    (("--deep_cache", "3"), "item 15"), (("--encoder_reuse", "3"), "item 15"),
    (("--int8",), "item 15"), (("--int8_all",), "item 15"), (("--data_parallel",), "item 16"),
    (("--normals_conditioning_mode", "ip_adapter"), "item 14"),
    (("--attention_backend", "xla"), "follow-up 5"),
])
def test_unported_options_raise(trained, extra, item):
    _, _, out = trained
    with pytest.raises(NotImplementedError, match=item):
        t_test.main(_infer_argv(trained, "--brushnet_path", out, *extra))


def test_entry_point_defaults_to_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, out = trained
    argv = _infer_argv(trained, "--brushnet_path", out)
    i = argv.index("--device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_test.main(argv[:i] + argv[i + 2:])
