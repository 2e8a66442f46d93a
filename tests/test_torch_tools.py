"""The port's host tools (`reflecting_reality_tpu_torch/tools/`) against the
JAX package's on the same inputs, on the CPU: one case for each test of
tests/test_tools.py on the `make_synmirror_data` fixtures (the corruption
scanner, the HDF5 extractor, the HTML gallery, the caption summarizer's
fallback, the splits, the camera-pose map, the ingest verifier), then
`convert_lpips --torch_ckpt` (the .npz equal to the JAX tool's), the
synthetic full-scale fixture (its tiny checkpoint loads strictly into the
port's modules; its data shard equals the JAX tool's) and the two
refusals of packages that are not installed.  Every output is compared
exactly: the tools compute no floating point of their own."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from tests.tiny_checkpoint import make_synmirror_data
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan_data")
    make_synmirror_data(str(d), n=3, size=32)
    return str(d)


@pytest.fixture()
def corpus(tmp_path):
    """A fresh corpus whose index nothing has rewritten."""
    d = tmp_path / "corpus"
    make_synmirror_data(str(d), n=3, size=32)
    return str(d)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ------------------------------------------------------------ test_dataset

def test_scanner_clean_dataset(data_dir):
    from reflecting_reality_tpu.tools import test_dataset as jtool
    from reflecting_reality_tpu_torch.tools import test_dataset as tool

    assert tool.scan(data_dir) == jtool.scan(data_dir) == []


def test_scanner_detects_corruption(tmp_path):
    from reflecting_reality_tpu.tools import test_dataset as jtool
    from reflecting_reality_tpu_torch.tools import test_dataset as tool

    bad = tmp_path / "bad"
    os.makedirs(bad / "obj")
    rng = np.random.RandomState(0)
    with h5py.File(bad / "obj/black.hdf5", "w") as f:
        f["colors"] = np.zeros((16, 16, 3), np.uint8)
        f["category_id_segmaps"] = np.ones((16, 16), np.uint8)
        f["depth"] = rng.rand(16, 16).astype(np.float32)
        f["normals"] = rng.rand(16, 16, 3).astype(np.float32)
    with h5py.File(bad / "obj/nomirror.hdf5", "w") as f:
        f["colors"] = np.full((16, 16, 3), 128, np.uint8)
        f["category_id_segmaps"] = np.zeros((16, 16), np.uint8)
        f["depth"] = np.ones((16, 16), np.float32)
        f["normals"] = rng.rand(16, 16, 3).astype(np.float32)
    got = tool.scan(str(bad), output_dir=str(tmp_path / "renders"))
    assert got == jtool.scan(str(bad), output_dir=str(tmp_path / "jrenders"))
    assert dict(got)["obj/black.hdf5"] == "Black image"
    assert "mirror" in dict(got)["obj/nomirror.hdf5"]
    assert _tree(tmp_path / "renders") == _tree(tmp_path / "jrenders") != {}


def test_scanner_cli_report(data_dir, tmp_path):
    from reflecting_reality_tpu.tools import test_dataset as jtool
    from reflecting_reality_tpu_torch.tools import test_dataset as tool

    for mod, name in ((tool, "r.txt"), (jtool, "j.txt")):
        mod.main(["--data_dir", data_dir, "--report", str(tmp_path / name)])
    assert open(tmp_path / "r.txt").read() == open(tmp_path / "j.txt").read() == ""


# ------------------------------------------------------------- hdf5extract

def test_extract(data_dir, tmp_path):
    from reflecting_reality_tpu.tools import hdf5extract as jtool
    from reflecting_reality_tpu_torch.tools import hdf5extract as tool

    for mod, out in ((tool, "ex"), (jtool, "jex")):
        mod.main(["--input", os.path.join(data_dir, "obj"), "--output_dir",
                  str(tmp_path / out), "--save_npy"])
    got = _tree(tmp_path / "ex")
    assert got == _tree(tmp_path / "jex")
    for suffix in ("cam.json", "colors.png", "depth.npy", "depth.png", "mirror_mask.png",
                   "normals.png", "object_mask.png", "segmap.png"):
        assert f"0_{suffix}" in got
    assert np.asarray(json.loads(got["0_cam.json"])["cam2world"]).shape == (4, 4)


# --------------------------------------------------------------- visualise

def test_html_gallery(tmp_path):
    import pandas as pd
    from PIL import Image

    from reflecting_reality_tpu.tools import visualise as jtool
    from reflecting_reality_tpu_torch.tools import visualise as tool

    infer = tmp_path / "infer"
    infer.mkdir()
    for uid in ("a_0", "b_0"):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(infer / f"{uid}.png")
    pd.DataFrame({"uid": ["a_0", "b_0"], "PSNR": [20.0, 25.0],
                  "mask_SSIM": [0.9, 0.8]}).to_csv(infer / "eval_0.csv", index=False)
    pd.DataFrame({"uid": ["a", "b"], "path": ["abo/x/0.hdf5", "novel/y/0.hdf5"]}).to_csv(
        tmp_path / "test.csv", index=False)
    cards = tool.collect(str(infer), test_csv=str(tmp_path / "test.csv"))
    assert cards == jtool.collect(str(infer), test_csv=str(tmp_path / "test.csv"))
    assert len(cards) == 2 and cards[0]["metrics"]["seed0/PSNR"] == 20.0
    assert cards[0]["tags"] == ["abo"] and cards[1]["tags"] == ["novel"]
    page = open(tool.write_html(str(infer), cards)).read()
    assert page == open(jtool.write_html(str(infer), cards)).read()
    assert "a_0.png" in page and "seed0/mask_SSIM" in page


def test_fiftyone_backend_names_the_missing_package(tmp_path, monkeypatch):
    from reflecting_reality_tpu_torch.tools import visualise as tool

    monkeypatch.setitem(sys.modules, "fiftyone", None)
    (tmp_path / "a_0.png").write_bytes(b"")
    with pytest.raises(RuntimeError, match="fiftyone"):
        tool.main(["--infer_dir", str(tmp_path), "--backend", "fiftyone"])


# ------------------------------------------------------ summarize_captions

def test_summarizer_fallback_truncation(tmp_path, monkeypatch):
    import pandas as pd

    from reflecting_reality_tpu.tools import summarize_captions as jtool
    from reflecting_reality_tpu_torch.tools import summarize_captions as tool

    # transformers is installed here and would try to download its model
    monkeypatch.setitem(sys.modules, "transformers", None)
    f = tool.summarize_fn(model_name="nonexistent-model", max_length=5)
    assert f("one two three four five six seven") == "one two three four five"
    csv = tmp_path / "c.csv"
    pd.DataFrame({"auto_caption": ["short one", "long " * 60]}).to_csv(csv, index=False)
    for mod, out in ((tool, "o.csv"), (jtool, "j.csv")):
        mod.main(["--csv", str(csv), "--out_csv", str(tmp_path / out),
                  "--model", "nonexistent-model", "--max_length", "8"])
    df = pd.read_csv(tmp_path / "o.csv")
    assert df.equals(pd.read_csv(tmp_path / "j.csv"))
    assert df["auto_caption"][0] == "short one" and len(df["auto_caption"][1].split()) == 8


# ----------------------------------------------------------- create_splits

def test_group_split(data_dir, tmp_path):
    import pandas as pd

    from reflecting_reality_tpu.tools import create_splits as jtool
    from reflecting_reality_tpu_torch.tools import create_splits as tool

    outs = {}
    for mod, name in ((tool, "port"), (jtool, "jax")):
        d = shutil.copytree(data_dir, tmp_path / name)
        mod.main(["--data_dir", str(d), "--test_fraction", "0.34", "--seed", "0"])
        outs[name] = [open(d / f).read() for f in ("train.csv", "test.csv")]
    assert outs["port"] == outs["jax"]
    train = pd.read_csv(tmp_path / "port" / "train.csv")
    test = pd.read_csv(tmp_path / "port" / "test.csv")
    assert len(train) + len(test) == 3 and "auto_caption" in train.columns
    assert set(train["uid"]).isdisjoint(set(test["uid"]))


# -------------------------------------------------- create_novel_cam_poses

def test_cam_pose_map(data_dir, tmp_path):
    from reflecting_reality_tpu.tools import create_novel_cam_poses as jtool
    from reflecting_reality_tpu_torch.tools import create_novel_cam_poses as tool

    views = tmp_path / "views"
    views.mkdir()
    for i in range(2):
        shutil.copy(os.path.join(data_dir, "obj", f"{i}.hdf5"), views / f"{i}.hdf5")
    m = tool.build_map(str(views), points=[(10, 20), (30, 40)])
    assert m == jtool.build_map(str(views), points=[(10, 20), (30, 40)])
    assert set(next(iter(m.values()))) == {"point", "ratio_w", "ratio_h", "floor_path"}


# -------------------------------------------------------- verify_synmirror

def test_verify_clean_corpus_manifest(corpus, tmp_path):
    from reflecting_reality_tpu.tools import verify_synmirror as jtool
    from reflecting_reality_tpu_torch.tools import verify_synmirror as tool

    manifests = {}
    for mod, name in ((tool, "m.json"), (jtool, "j.json")):
        assert mod.main(["--data_dir", corpus, "--csv", "train.csv",
                         "--manifest", str(tmp_path / name), "--checksums"]) == 0
        manifests[name] = json.load(open(tmp_path / name))
    m = manifests["m.json"]
    assert m == manifests["j.json"]
    assert m["n_files"] == 3 and m["corrupt"] == [] and m["index"]["missing_rows"] == []
    assert m["files"]["obj/0.hdf5"]["keys"]["colors"] == {"dtype": "uint8",
                                                          "shape": [32, 32, 3]}


def test_verify_schema_violations(tmp_path):
    from reflecting_reality_tpu.tools import verify_synmirror as jtool
    from reflecting_reality_tpu_torch.tools import verify_synmirror as tool

    bad = tmp_path / "bad.hdf5"
    rng = np.random.RandomState(0)
    with h5py.File(bad, "w") as f:
        f["colors"] = rng.rand(16, 16, 3).astype(np.float32)  # wrong kind
        f["category_id_segmaps"] = np.ones((16, 16), np.uint8)
        f["depth"] = rng.rand(8, 8).astype(np.float32)        # dim mismatch
        f["cam_states"] = np.frombuffer(b"{not json", dtype=np.uint8)
    rec = tool.inspect_file(str(bad), content_scan=False)
    assert rec == jtool.inspect_file(str(bad), content_scan=False)
    joined = "; ".join(rec["errors"])
    for want in ("missing key normals", "kind", "inconsistent spatial dims", "undecodable"):
        assert want in joined


def test_verify_index_coverage_and_rc(corpus, tmp_path):
    from reflecting_reality_tpu.tools import verify_synmirror as jtool
    from reflecting_reality_tpu_torch.tools import verify_synmirror as tool

    broken = shutil.copytree(corpus, tmp_path / "broken")
    os.remove(broken / "obj/2.hdf5")
    argv = ["--data_dir", str(broken), "--csv", "train.csv"]
    assert tool.main(argv) == jtool.main(argv) == 1
    m = tool.build_manifest(str(broken), "train.csv", False, 2)
    assert m["index"]["missing_rows"] == ["obj/2.hdf5"]


def test_verify_manifest_comparison_detects_drift(corpus, tmp_path):
    from reflecting_reality_tpu.tools import verify_synmirror as jtool
    from reflecting_reality_tpu_torch.tools import verify_synmirror as tool

    ref = str(tmp_path / "ref.json")
    assert jtool.main(["--data_dir", corpus, "--csv", "train.csv", "--manifest", ref,
                       "--checksums"]) == 0
    copy = shutil.copytree(corpus, tmp_path / "copy")
    argv = ["--data_dir", str(copy), "--csv", "train.csv", "--checksums", "--expect", ref]
    assert tool.main(argv) == 0          # the port verifies a JAX manifest
    with h5py.File(copy / "obj/1.hdf5", "r+") as f:
        d = np.array(f["depth"])
        del f["depth"]
        f["depth"] = d + 1e-3
    assert tool.main(argv) == jtool.main(argv) == 1
    actual = tool.build_manifest(str(copy), "train.csv", True, 2)
    assert tool.compare_manifests(json.load(open(ref)), actual) == ["obj/1.hdf5: sha256 mismatch"]


# ----------------------------------------------------------- convert_lpips

def test_convert_lpips_torch_ckpt_equals_jax(tmp_path):
    import torch

    from reflecting_reality_tpu.tools import convert_lpips as jtool
    from reflecting_reality_tpu_torch.core.io import load_into
    from reflecting_reality_tpu_torch.metrics.lpips import LPIPS, load_lpips_npz
    from reflecting_reality_tpu_torch.tools import convert_lpips as tool
    from tests.test_torch_eval import _torch_layout_state

    ckpt = tmp_path / "squeeze.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _torch_layout_state(0).items()}, ckpt)
    for mod, out in ((tool, "port.npz"), (jtool, "jax.npz")):
        mod.main(["--torch_ckpt", str(ckpt), "--out", str(tmp_path / out)])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as ref:
        assert sorted(got.files) == sorted(ref.files) and len(got.files) == 57
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k])
    load_into(LPIPS(), load_lpips_npz(str(tmp_path / "port.npz")))


def test_convert_lpips_from_torchmetrics_names_the_missing_package(tmp_path, monkeypatch):
    from reflecting_reality_tpu_torch.tools import convert_lpips as tool

    monkeypatch.setitem(sys.modules, "torchmetrics", None)
    with pytest.raises(RuntimeError, match="torchmetrics"):
        tool.main(["--from_torchmetrics", "--out", str(tmp_path / "x.npz")])


# ------------------------------------------------- make_synthetic_fullscale

def test_make_synthetic_fullscale_tiny(tmp_path):
    import pandas as pd

    from reflecting_reality_tpu.tools import make_synthetic_fullscale as jtool
    from reflecting_reality_tpu_torch.core.io import load_pretrained
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.tools import make_synthetic_fullscale as tool

    out = tmp_path / "e2e"
    tool.main(["--out", str(out), "--tiny", "--n", "4", "--size", "64", "--device", "cpu"])
    base = str(out / "sd15")
    unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    assert unet.block_out_channels == (8, 16, 16, 16)
    load_pretrained(AutoencoderKL, base, subfolder="vae")
    assert load_text_encoder(base).hidden_size == 32
    ids = CLIPTokenizer.from_pretrained(base, subfolder="tokenizer")(["a mirror"])
    assert ids.shape == (1, 77) and ids.max() < 49408

    jtool.make_data(str(tmp_path / "jdata"), n=4, size=64)
    for csv in ("train.csv", "test.csv"):
        assert pd.read_csv(out / "data" / csv).equals(pd.read_csv(tmp_path / "jdata" / csv))
    for i in range(4):
        with h5py.File(out / f"data/obj/{i}.hdf5") as f, \
                h5py.File(tmp_path / f"jdata/obj/{i}.hdf5") as g:
            assert sorted(f) == sorted(g)
            for k in f:
                np.testing.assert_array_equal(f[k][()], g[k][()])
    tdir = tmp_path / "jtok"
    jtool.write_byte_tokenizer(str(tdir))
    assert _tree(tdir) == _tree(out / "sd15" / "tokenizer")
