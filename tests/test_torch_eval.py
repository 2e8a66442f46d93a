"""The port's evaluation stack against the JAX package on the CPU, in fp32:
LPIPS (weights carried across through the JAX .npz and a torch state dict),
the CLIP towers with projection and their scorers, MetricsCalculator on
every PSNR/SSIM/LPIPS name of the full, mask and mirror families (and
obj_*/IoU with a stub segmenter), the segmentation helpers, and
`metrics/evaluate.py`'s calc/best/avg CSVs and sharding.

Tolerances: LPIPS 1e-5 relative (fp32 both sides; the difference is
summation order through ~26 convolutions); CLIP towers 1e-5 (2 layers);
PSNR/SSIM/LPIPS cells and CSVs 1e-5 relative; clip_preprocess,
the segmentation helpers and the row handling exactly."""

import json
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from reflecting_reality_tpu.metrics import calculator as j_calc
from reflecting_reality_tpu.metrics import evaluate as j_eval
from reflecting_reality_tpu.metrics import lpips as j_lpips
from reflecting_reality_tpu.metrics import segmentation as j_seg
from reflecting_reality_tpu.models import clip_text as j_clip_text
from reflecting_reality_tpu.models import clip_vision as j_clip_vision
from reflecting_reality_tpu.parallel.mesh import split_between_processes as j_split
from reflecting_reality_tpu_torch.core.io import load_into, save_safetensors
from reflecting_reality_tpu_torch.metrics import calculator as t_calc
from reflecting_reality_tpu_torch.metrics import evaluate as t_eval
from reflecting_reality_tpu_torch.metrics import lpips as t_lpips
from reflecting_reality_tpu_torch.metrics import segmentation as t_seg
from reflecting_reality_tpu_torch.metrics.scorers import build_extra_scorers
from reflecting_reality_tpu_torch.models import clip_text as t_clip_text
from reflecting_reality_tpu_torch.models import clip_vision as t_clip_vision
from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes
from tests.test_segmentation import FakeSegmenter, cam_pose_map_for, make_gt_data
from tests.test_torch_helpers import init_jax, nhwc_to_nchw, to_torch
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-5


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """JAX LPIPS initialised from a seed (lin heads made non-negative, as in
    the real checkpoint), written by the JAX package's save_lpips_npz."""
    params = j_lpips.LPIPS().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(lambda x: np.abs(np.asarray(x)), params)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_squeeze.npz")
    j_lpips.save_lpips_npz(params, path)
    return path, params


def _torch_layout_state(seed):
    """A richzhang-layout torch LPIPS(squeeze) state dict from a seed."""
    rng = np.random.RandomState(seed)

    def w(c_out, c_in, k):
        return (0.1 * rng.randn(c_out, c_in, k, k)).astype(np.float32)

    state = {"net.features.0.weight": w(64, 3, 3),
             "net.features.0.bias": rng.randn(64).astype(np.float32)}
    fires = {3: (16, 64, 64), 4: (16, 128, 64), 6: (32, 128, 128), 7: (32, 256, 128),
             9: (48, 256, 192), 10: (48, 384, 192), 11: (64, 384, 256), 12: (64, 512, 256)}
    for idx, (sq, c_in, ex) in fires.items():
        for name, shape in (("squeeze", (sq, c_in, 1)), ("expand1x1", (ex, sq, 1)),
                            ("expand3x3", (ex, sq, 3))):
            state[f"net.features.{idx}.{name}.weight"] = w(*shape)
            state[f"net.features.{idx}.{name}.bias"] = (0.1 * rng.randn(shape[0])).astype(
                np.float32)
    for i, ch in enumerate((64, 128, 256, 384, 384, 512, 512)):
        state[f"lin{i}.model.1.weight"] = np.abs(w(1, ch, 1))
    return state


@pytest.mark.parametrize("size", [64, 67])
def test_lpips_matches_jax(lpips_npz, size):
    """The same weights through the JAX .npz and through a torch state dict
    give JAX's scores; at 67² the ceil-mode pools emit their extra window."""
    path, params = lpips_npz
    rng = np.random.RandomState(size)
    a, b = ((rng.rand(2, size, size, 3) * 2 - 1).astype(np.float32) for _ in range(2))
    port = load_into(t_lpips.LPIPS(), t_lpips.load_lpips_npz(path)).eval()
    ref = float(j_lpips.LPIPS().apply(params, a, b))
    with torch.no_grad():
        got = float(port(nhwc_to_nchw(a), nhwc_to_nchw(b)))
    assert got == pytest.approx(ref, rel=RTOL) and ref > 0

    state = _torch_layout_state(size)
    port = load_into(t_lpips.LPIPS(), t_lpips.load_torch_lpips_state(state)).eval()
    ref = float(j_lpips.LPIPS().apply(j_lpips.load_torch_lpips_state(state), a, b))
    with torch.no_grad():
        got = float(port(nhwc_to_nchw(a), nhwc_to_nchw(b)))
    assert got == pytest.approx(ref, rel=RTOL)


def test_lpips_npz_written_by_the_port_loads_in_jax(lpips_npz, tmp_path):
    path, params = lpips_npz
    state = t_lpips.load_lpips_npz(path)
    out = str(tmp_path / "port.npz")
    t_lpips.save_lpips_npz(state, out)
    back = j_lpips.load_lpips_npz(out)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))


# ----------------------------------------------------------------- CLIP

TINY_VISION = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=64, image_size=32, patch_size=8, projection_dim=16)
TINY_TEXT_PROJ = dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64, projection_dim=16,
                      eos_token_id=513)


@pytest.fixture(scope="module")
def clip_towers():
    jv = j_clip_vision.CLIPVisionModelWithProjection(**TINY_VISION)
    vp = init_jax(jv, jnp.zeros((1, 32, 32, 3)), seed=4)
    jt = j_clip_text.CLIPTextModelWithProjection(**TINY_TEXT_PROJ)
    tp = init_jax(jt, jnp.zeros((1, 77), jnp.int32), seed=5)
    tv = to_torch(t_clip_vision.CLIPVisionModelWithProjection(**TINY_VISION), vp)
    tt = to_torch(t_clip_text.CLIPTextModelWithProjection(**TINY_TEXT_PROJ), tp)
    return (jv, vp, tv), (jt, tp, tt)


def test_clip_vision_matches_jax(clip_towers):
    (jv, vp, tv), _ = clip_towers
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    ref_last, ref_emb = jv.apply(vp, x)
    with torch.no_grad():
        last, emb = tv(nhwc_to_nchw(x))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), rtol=RTOL, atol=RTOL)


def test_clip_text_with_projection_matches_jax(clip_towers):
    _, (jt, tp, tt) = clip_towers
    ids = np.random.RandomState(1).randint(0, 513, (2, 77)).astype(np.int32)
    ids[0, 9:], ids[1, 30:] = 513, 513          # EOS-padded, at two lengths
    ref_last, ref_pooled = jt.apply(tp, jnp.asarray(ids))
    with torch.no_grad():
        last, pooled = tt(torch.from_numpy(ids).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("shape", [(50, 70, 3), (224, 224, 3), (300, 200, 3)])
def test_clip_preprocess_is_bit_identical(shape):
    img = np.random.RandomState(2).randint(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(t_clip_vision.clip_preprocess(img, 32),
                                  j_clip_vision.clip_preprocess(img, 32))


def test_clip_scorers_load_a_whole_clip_folder(clip_towers, tmp_path):
    """A transformers-layout CLIP folder (both towers, text_config /
    vision_config, vocab) and a LAION-style linear head: the scorers'
    numbers equal the JAX towers' on the same weights and tokens."""
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer, write_byte_vocab

    (jv, vp, tv), (jt, tp, tt) = clip_towers
    folder = str(tmp_path / "clip")
    write_byte_vocab(folder)
    state = {**tv.state_dict(), **tt.state_dict(), "logit_scale": torch.tensor(4.6)}
    save_safetensors(state, os.path.join(folder, "model.safetensors"))
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump({"text_config": TINY_TEXT_PROJ, "vision_config": TINY_VISION}, f)
    head = str(tmp_path / "aesthetic.pth")
    g = torch.Generator().manual_seed(0)
    torch.save({"weight": torch.randn(1, 16, generator=g), "bias": torch.randn(1, generator=g)},
               head)

    scorers = build_extra_scorers(folder, head, device="cpu")
    assert sorted(scorers) == ["Aesthetic_Score", "CLIP_Similarity"]
    image = np.random.RandomState(3).randint(0, 256, (64, 48, 3), np.uint8)
    caption = "a mirror on a wall"
    ie = np.asarray(jv.apply(vp, j_clip_vision.clip_preprocess(image, 32))[1])
    ie = ie / np.linalg.norm(ie, axis=-1, keepdims=True)
    ids = np.asarray(CLIPTokenizer.from_pretrained(folder)([caption]))
    te = np.asarray(jt.apply(tp, jnp.asarray(ids))[1])
    te = te / np.linalg.norm(te, axis=-1, keepdims=True)
    want_clip = max(float((ie * te).sum()), 0.0) * 100.0
    sd = torch.load(head)
    want_aes = float((ie @ sd["weight"].numpy().T + sd["bias"].numpy())[0, 0])
    assert scorers["CLIP_Similarity"](image, caption) == pytest.approx(want_clip, rel=1e-4,
                                                                        abs=1e-4)
    assert scorers["Aesthetic_Score"](image, caption) == pytest.approx(want_aes, rel=1e-4,
                                                                        abs=1e-5)


# ------------------------------------------------------------ calculator

FAMILIES = j_eval.full_metrics + j_eval.mask_metrics + j_eval.mirror_metrics


def _gt_sample():
    rng = np.random.RandomState(7)
    gt = make_gt_data()
    gt["masked_image"] = gt["image"] * (gt["mask"] != 255)[..., None].astype(np.uint8)
    gen = np.clip(gt["image"].astype(int) + rng.randint(-40, 40, gt["image"].shape),
                  0, 255).astype(np.uint8)
    return gt, gen


@pytest.mark.parametrize("metric", FAMILIES)
def test_calculator_matches_jax(lpips_npz, metric):
    path, _ = lpips_npz
    gt, gen = _gt_sample()
    ref = j_calc.MetricsCalculator([metric], lpips_weights=path).compute_metric(
        metric, gen, gt, "cap")
    got = t_calc.MetricsCalculator([metric], lpips_weights=path, device="cpu").compute_metric(
        metric, gen, gt, "cap")
    assert np.isfinite(got) and got == pytest.approx(ref, rel=RTOL)


def test_calculator_obj_and_iou_match_jax(lpips_npz, tmp_path):
    """obj_* and IoU through a stub segmenter, each package with its own
    sam_cache (written by the first call, read by the rest)."""
    path, _ = lpips_npz
    gt, gen = _gt_sample()
    cmap, _ = cam_pose_map_for((1.0, 2.0, 2.0))
    got = {}
    for name, mod, kw in (("jax", j_calc, {}), ("port", t_calc, {"device": "cpu"})):
        calc = mod.MetricsCalculator(["PSNR"], data_dir=str(tmp_path / name), lpips_weights=path,
                                     **kw)
        calc._segmenter, calc._cam_pose_map = FakeSegmenter(), cmap
        got[name] = [calc.compute_metric(m, gen, gt, "cap")
                     for m in ("IoU", "obj_PSNR", "obj_SSIM", "obj_LPIPS", "IoU")]
        assert os.path.exists(tmp_path / name / "sam_cache" / "hdf5" / "xyz" / "0.png")
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL)


def test_calculator_error_branches(lpips_npz, monkeypatch):
    gt, gen = _gt_sample()
    calc = t_calc.MetricsCalculator([], device="cpu")
    for name in ("CLIP_Similarity", "Aesthetic_Score", "LPIPS", "Image_Reward", "HPS_V2.1"):
        with pytest.raises(RuntimeError):
            calc.compute_metric(name, gen, gt, "cap")
    with pytest.raises(ValueError, match="Unsupported"):
        calc.compute_metric("FID", gen, gt, "cap")
    calc.extra_scorers["CLIP_Similarity"] = lambda image, caption: 7.0
    assert calc.compute_metric("CLIP_Similarity", gen, gt, "cap") == 7.0
    monkeypatch.setitem(sys.modules, "segment_anything", None)
    with pytest.raises(ImportError, match="segment_anything"):
        t_calc.MetricsCalculator(["IoU"], device="cpu")
    out = t_calc.compute_metrics(gen, gt["image"], device="cpu")
    ref = j_calc.compute_metrics(gen, gt["image"])
    assert np.isnan(out["lpips"]) and np.isnan(ref["lpips"])
    for k in ("psnr", "ssim"):
        assert out[k] == pytest.approx(ref[k], rel=RTOL)


def test_calculator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_calc.MetricsCalculator([])


# ---------------------------------------------------------- segmentation

@pytest.mark.parametrize("translation,cmap_t,listed", [
    ((1.0, 2.0, 2.0), (1.0, 2.0, 2.0), False), ((-1.0, 2.0, 2.0), (-1.0, 2.0, 2.0), False),
    ((1.01, 2.0, 2.0), (1.0, 2.0, 2.0), False), ((1.0, 2.0, 2.0), (1.0, 2.0, 2.0), True),
    ((1.0, 2.0, 2.0), None, False)])
def test_segmentation_prompt_points_match_jax(translation, cmap_t, listed):
    if cmap_t is None:
        cmap = {"not-a-number": {}}
    else:
        cmap, key = cam_pose_map_for(cmap_t)
        if listed:
            cmap[str(key)] = [cmap[str(key)]]
    gt = make_gt_data(translation)
    assert t_seg.get_point_from_cam_states(gt, cmap) == j_seg.get_point_from_cam_states(gt, cmap)


def test_segmentation_helpers_match_jax(tmp_path, monkeypatch):
    m = np.zeros((64, 64), np.uint8)
    m[10:20, 30:44] = 1
    for mask in (m, np.zeros_like(m)):
        assert t_seg.get_bbox_from_mask(mask) == j_seg.get_bbox_from_mask(mask)
    for args in (((10, 10), 8, 8), ((100, 100), 60, 80)):
        assert t_seg.create_bbox_from_point(*args) == j_seg.create_bbox_from_point(*args)
    vec = np.array([-1.0, 0.0, 2.0])
    np.testing.assert_array_equal(t_seg.create_sign_vector(vec), j_seg.create_sign_vector(vec))

    cmap, _ = cam_pose_map_for((1.0, 2.0, 2.0), floor_path="7.png")
    from PIL import Image

    floor = np.zeros((64, 64), np.uint8)
    floor[50:54, 10:30] = 255
    (tmp_path / "metrics" / "floor_masks").mkdir(parents=True)
    Image.fromarray(floor).save(tmp_path / "metrics" / "floor_masks" / "7.png")
    with open(tmp_path / "metrics" / "cam_pose_map.json", "w") as f:
        json.dump(cmap, f)
    assert t_seg.load_cam_pose_map(str(tmp_path)) == j_seg.load_cam_pose_map(str(tmp_path))
    gt = make_gt_data()
    for kw in (dict(use_floor_mask=True), dict(use_gt_mask=True), {}):
        outs = {}
        for name, mod in (("jax", j_seg), ("port", t_seg)):
            cache = str(tmp_path / name / "cache" / "0.png")
            first = mod.segment_image(gt, gt["image"][::-1].copy(), FakeSegmenter(), cmap,
                                      gt_sam_cache=cache, data_dir=str(tmp_path), **kw)
            again = mod.segment_image(gt, gt["image"][::-1].copy(), FakeSegmenter(), cmap,
                                      gt_sam_cache=cache, data_dir=str(tmp_path), **kw)
            for x, y in zip(first, again):
                np.testing.assert_array_equal(x, y)
            outs[name] = first
        for x, y in zip(outs["port"], outs["jax"]):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(t_seg.EmptyObjectMaskError):
        t_seg.segment_image(make_gt_data(with_object=False), gt["image"], FakeSegmenter(), cmap)
    with pytest.raises(FileNotFoundError):
        t_seg.load_cam_pose_map(str(tmp_path / "nope"))

    # no network: a missing SAM checkpoint raises and names its path
    fake = types.SimpleNamespace(SamPredictor=object, sam_model_registry={})
    monkeypatch.setitem(sys.modules, "segment_anything", fake)
    with pytest.raises(FileNotFoundError, match="sam_vit_h_4b8939.pth"):
        t_seg.SegmentPoints(checkpoint_folder=str(tmp_path / "ckpt"))


def test_segmenter_follows_the_calculator_device(tmp_path, monkeypatch):
    """The SAM model moves to the segmenter's device before SamPredictor
    wraps it: the calculator hands over its own device, and the segmenter's
    default is the card."""
    moved = []

    class Sam:
        def to(self, device):
            moved.append(str(device))
            return self

    fake = types.SimpleNamespace(SamPredictor=lambda model: ("predictor", model),
                                 sam_model_registry={"vit_h": lambda checkpoint: Sam()})
    monkeypatch.setitem(sys.modules, "segment_anything", fake)
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "sam_vit_h_4b8939.pth").write_bytes(b"")
    cmap, _ = cam_pose_map_for((1.0, 2.0, 2.0))
    with open(tmp_path / "cam_pose_map.json", "w") as f:
        json.dump(cmap, f)
    calc = t_calc.MetricsCalculator(["IoU"], data_dir=str(tmp_path),
                                    ckpt_path=str(tmp_path / "ckpt"), device="cpu")
    assert moved == ["cpu"] and calc._segmenter.predictor[0] == "predictor"
    t_seg.SegmentPoints(checkpoint_folder=str(tmp_path / "ckpt"))
    assert moved == ["cpu", "cuda"]


# -------------------------------------------------------------- evaluate

N_UIDS = 2


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """make_synmirror_data at 64², and 2x2 sheets drawn from a seed (seed
    image k = GT plus noise of scale k) in one infer dir per package."""
    from PIL import Image

    from reflecting_reality_tpu_torch.data.synmirror import extract_data_from_hdf5
    from tests.tiny_checkpoint import make_synmirror_data
    import h5py

    data = str(tmp_path_factory.mktemp("eval_data"))
    make_synmirror_data(data, n=N_UIDS, size=64)
    rng = np.random.RandomState(11)
    sheets = {}
    for i in range(N_UIDS):
        with h5py.File(os.path.join(data, f"obj/{i}.hdf5"), "r") as f:
            img = extract_data_from_hdf5(f)["image"].astype(int)
        grid = Image.new("RGB", (128, 128))
        for k in range(4):
            noisy = np.clip(img + rng.randint(-1, 2, img.shape) * 20 * (k + 1), 0, 255)
            grid.paste(Image.fromarray(noisy.astype(np.uint8)), (k % 2 * 64, k // 2 * 64))
        sheets[f"uid{i}_{i}.png"] = grid
    dirs = {}
    for name in ("jax", "port", "port_sharded"):
        d = str(tmp_path_factory.mktemp(f"infer_{name}"))
        for fname, grid in sheets.items():
            grid.save(os.path.join(d, fname))
        dirs[name] = d
    return data, dirs


def _csv(d, name):
    return pd.read_csv(os.path.join(d, name)).sort_values("uid").reset_index(drop=True)


def test_evaluate_calc_best_avg_match_jax(eval_dirs, lpips_npz):
    data, dirs = eval_dirs
    weights, _ = lpips_npz
    base = ["--train_data_dir", data, "--metrics", "mask", "PSNR", "LPIPS",
            "--lpips_weights", weights]
    for name, mod, extra in (("jax", j_eval, []), ("port", t_eval, ["--device", "cpu"]),
                             ("port_sharded", t_eval, ["--device", "cpu"])):
        argv = base + ["--infer_dir", dirs[name]] + extra
        if name == "port_sharded":       # shard 1 writes its piece, shard 0 merges
            for shard in ("1", "0"):
                mod.main(argv + ["--mode", "calc", "--num_shards", "2", "--shard_id", shard])
        else:
            mod.main(argv + ["--mode", "calc"])
        mod.main(argv + ["--mode", "best", "--select_metric", "mask_PSNR"])
        mod.main(argv + ["--mode", "avg", "--select_metric", "mask_PSNR"])
    metrics = [c for c in j_eval.all_metrics]
    for name in ("port", "port_sharded"):
        for f in [f"eval_{i}.csv" for i in range(4)] + ["eval_best.csv"]:
            want, got = _csv(dirs["jax"], f), _csv(dirs[name], f)
            assert list(got["uid"]) == list(want["uid"]) and len(got) == N_UIDS
            assert list(got.columns) == list(want.columns)
            np.testing.assert_allclose(got[metrics].to_numpy(float),
                                       want[metrics].to_numpy(float), rtol=RTOL, err_msg=f)
        want = pd.read_csv(os.path.join(dirs["jax"], "eval_avg.csv"))
        got = pd.read_csv(os.path.join(dirs[name], "eval_avg.csv"))
        assert list(got["Metric"]) == list(want["Metric"])
        np.testing.assert_allclose(got["Dataset Average"].to_numpy(float),
                                   want["Dataset Average"].to_numpy(float), rtol=RTOL)
    # the merge removed the shards' pieces (eval_{i}_{shard}.csv)
    pieces = [f for f in os.listdir(dirs["port_sharded"]) if re.fullmatch(r"eval_\d+_\d+\.csv", f)]
    assert not pieces, pieces
    best = _csv(dirs["port"], "eval_best.csv")
    assert best[["PSNR", "LPIPS", "mask_PSNR", "mask_SSIM", "mask_LPIPS"]].notna().all().all()


def test_evaluate_parser_keeps_every_jax_flag_and_default():
    jax_actions = {a.dest: a for a in j_eval.build_parser()._actions}
    port_actions = {a.dest: a for a in t_eval.build_parser()._actions}
    assert set(port_actions) == set(jax_actions) | {"device"}
    for dest, ja in jax_actions.items():
        for field in ("option_strings", "default", "choices", "required", "nargs", "type"):
            assert getattr(port_actions[dest], field) == getattr(ja, field), (dest, field)
    assert port_actions["device"].default == "cuda"


@pytest.mark.parametrize("n,count", [(10, 3), (2, 4), (7, 1), (0, 2)])
def test_split_between_processes_matches_jax(n, count):
    for rank in range(count):
        assert split_between_processes(range(n), rank, count) == j_split(range(n), rank, count)
    assert split_between_processes(range(n)) == list(range(n))
