"""The port's data layer against the JAX package's: the SynMirror transforms
(native library on and off), the HDF5, MSD and latent-cache datasets, the
item RNG, the loader's batch order, `materialize_cache`, and
`prefetch_to_device` on the CPU.  Data moves without arithmetic or through
the same numpy/PIL/C++ code, so every comparison is exact."""

import os
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from reflecting_reality_tpu.data import latent_cache as j_cache
from reflecting_reality_tpu.data import loader as j_loader
from reflecting_reality_tpu.data import native as j_native
from reflecting_reality_tpu.data import rng as j_rng
from reflecting_reality_tpu.data import synmirror as j_syn
from reflecting_reality_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from reflecting_reality_tpu_torch.data import latent_cache, loader, native, rng, synmirror
from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer, write_byte_vocab
from tests.tiny_checkpoint import make_synmirror_data, write_char_tokenizer
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dataset_transforms.npz")


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    """Both packages on their native library, or both on the numpy/PIL path."""
    if request.param == "numpy":
        for mod in (native, j_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    elif native.load() is None or j_native.load() is None:
        pytest.skip("native transforms unavailable (no g++?)")
    return request.param


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Synthetic SynMirror files, an MSD folder and a moments cache, with
    the CSV rows both ways (csv module for the port, pandas for JAX)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    syn = str(root / "syn")
    make_synmirror_data(syn, n=6, size=48)
    msd = root / "msd"
    r = np.random.RandomState(3)
    for sub in ("images", "masks", "depth"):
        (msd / sub).mkdir(parents=True)
    msd_rows = []
    for i in range(3):
        Image.fromarray(r.randint(0, 256, (40, 56, 3), np.uint8)).save(msd / "images" / f"{i}.png")
        m = np.zeros((40, 56), np.uint8)
        m[8:30, 10:40] = 255
        Image.fromarray(m).save(msd / "masks" / f"{i}.png")
        np.savez(msd / "depth" / f"{i}.npz", depth=(r.rand(40, 56) * 3).astype(np.float32))
        msd_rows.append({"path": f"{i}.png", "auto_caption": f"room {i}"})
    pd.DataFrame(msd_rows).to_csv(msd / "train.csv", index=False)
    cache = root / "cache"
    cache.mkdir()
    rows = synmirror.read_rows(os.path.join(syn, "train.csv"))
    for i, row in enumerate(rows):
        np.savez(cache / latent_cache.cache_name(row, i),
                 latent_moments=r.randn(6, 6, 8).astype(np.float16),
                 cond_latent_moments=r.randn(6, 6, 8).astype(np.float16),
                 masks=(r.rand(6, 6, 1) > 0.5).astype(np.float32),
                 depths=r.rand(6, 6, 1).astype(np.float32))
    tok = str(root / "tokenizer")
    write_byte_vocab(tok)
    return {"syn": syn, "msd": str(msd), "cache": str(cache), "tok": tok}


def _tokenizers(tree):
    return CLIPTokenizer.from_pretrained(tree["tok"]), JTokenizer.from_pretrained(tree["tok"])


def _rows(path):
    return synmirror.read_rows(path), pd.read_csv(path)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------ transforms

def test_transforms_match_jax_on_golden_inputs(golden, mode):
    img, mask, depth, normals = (golden[k] for k in ("image", "mask", "depth", "normals"))
    cases = [
        ("apply_transforms_rgb", (img, 512), {}),
        ("apply_transforms_mask", (mask, 512), {}),
        ("apply_transforms_depth", (depth,), dict(mask=mask, resolution=512)),
        ("apply_transforms_depth", (depth,), dict(mask=mask, norm_range=(0, 1), resolution=96)),
        ("apply_transforms_depth", (depth,), dict(normalization_method="percentile",
                                                  resolution=512)),
        ("apply_transforms_normals", (normals, 512), dict(mask=mask,
                                                          normals_conditioning_mode="image")),
        ("apply_transforms_normals", (normals,), dict(mask=mask)),
        ("get_masked_image", (img, mask), {}),
        ("get_masked_image", (img, mask), dict(invert=False)),
        ("normals_to_uint8", (normals,), {}),
    ]
    for name, args, kw in cases:
        got = getattr(synmirror, name)(*args, **kw)
        want = getattr(j_syn, name)(*args, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw}")


def test_hdf5_extraction_and_cam_states_match_jax(tree, mode):
    import h5py

    path = os.path.join(tree["syn"], "obj", "1.hdf5")
    for flip in (False, True):
        for keys in (None, {"image", "mask", "masked_image", "depth"}):
            with h5py.File(path, "r") as f:
                got = synmirror.extract_data_from_hdf5(f, random_flip=flip, keys=keys)
                want = j_syn.extract_data_from_hdf5(f, random_flip=flip, keys=keys)
            _equal(got, want)
    with h5py.File(path, "r") as f:
        cam = np.array(f["cam_states"])
    assert synmirror.decode_cam_states(cam) == j_syn.decode_cam_states(cam)


# -------------------------------------------------------------- datasets

@pytest.mark.parametrize("kw", [
    dict(depth=True),
    dict(depth=True, normals_conditioning_mode="concat", cam_states=True, random_flip=True,
         proportion_empty_prompts=0.5),
])
def test_hdf5_dataset_items_match_jax(tree, mode, kw):
    rows, df = _rows(os.path.join(tree["syn"], "train.csv"))
    tok, jtok = _tokenizers(tree)
    ds = synmirror.HDF5Dataset(tree["syn"], rows, tok, resolution=32, seed=7, **kw)
    jds = j_syn.HDF5Dataset(tree["syn"], df, jtok, resolution=32, seed=7, **kw)
    assert len(ds) == len(jds) == 6
    for epoch in (0, 1):
        ds.rng.epoch = jds.rng.epoch = epoch
        for i in range(len(ds)):
            _equal(ds[i], jds[i])


def test_msd_dataset_items_match_jax(tree, mode):
    rows, df = _rows(os.path.join(tree["msd"], "train.csv"))
    tok, jtok = _tokenizers(tree)
    ds = synmirror.MSDDataset(tree["msd"], rows, tok, resolution=32, seed=1, depth=True)
    jds = j_syn.MSDDataset(tree["msd"], df, jtok, resolution=32, seed=1, depth=True)
    for i in range(len(ds)):
        _equal(ds[i], jds[i])


def _cache_sets(tree, **kw):
    rows, df = _rows(os.path.join(tree["syn"], "train.csv"))
    tok, jtok = _tokenizers(tree)
    return (latent_cache.LatentCachedDataset(tree["cache"], rows, tok, seed=3, **kw),
            j_cache.LatentCachedDataset(tree["cache"], df, jtok, seed=3, **kw))


def test_latent_cache_dataset_and_index_view_match_jax(tree):
    ds, jds = _cache_sets(tree, proportion_empty_prompts=0.5)
    for i in range(len(ds)):
        _equal(ds[i], jds[i])
    view, jview = latent_cache.DeviceCacheIndexDataset(ds), j_cache.DeviceCacheIndexDataset(jds)
    for i in range(len(view)):
        _equal(view[i], jview[i])
    with pytest.raises(FileNotFoundError, match="precompute_latents"):
        latent_cache.LatentCachedDataset(tree["syn"], ds.rows, ds.tokenizer)


@pytest.mark.parametrize("transport", [None, "bf16"])
def test_materialize_cache_matches_jax(tree, transport):
    ds, jds = _cache_sets(tree)
    got = latent_cache.materialize_cache(
        ds, transport_dtype=torch.bfloat16 if transport else None, transport_exempt=("depths",))
    want = j_cache.materialize_cache(
        jds, transport_dtype=jnp.bfloat16 if transport else None, transport_exempt=("depths",))
    assert set(got) == set(want)
    for k in want:
        expect = torch.bfloat16 if transport and k != "depths" else torch.float32
        assert got[k].dtype == expect, k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))
    with pytest.raises(ValueError, match="RR_DEVICE_CACHE_MAX_GB"):
        latent_cache.materialize_cache(ds, max_bytes=10)


# ------------------------------------------------------------ rng, loader

def test_item_rng_draws_match_jax():
    for seed in (0, 5):
        a, b = rng.ItemRNG(seed), j_rng.ItemRNG(seed)
        for epoch in (0, 3):
            a.epoch = b.epoch = epoch
            for i in (0, 1, 17):
                np.testing.assert_array_equal(a.for_item(i).random(4), b.for_item(i).random(4))


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_batches_match_jax_over_two_epochs(tree, workers):
    ds, jds = _cache_sets(tree, proportion_empty_prompts=0.5)
    dl = loader.DataLoader(ds, 2, num_workers=workers, seed=11)
    jdl = j_loader.DataLoader(jds, 2, num_workers=workers, seed=11)
    assert len(dl) == len(jdl) == 3
    for _ in range(2):
        got, want = list(dl), list(jdl)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _equal(a, b)
    assert dl.epoch == 2 and ds.rng.epoch == 1
    _equal(loader.collate([ds[0], ds[1]]), j_loader.collate([jds[0], jds[1]]))


def _batches(n=3, b=2):
    r = np.random.RandomState(0)
    return [{"latent_moments": r.randn(b, 4, 4, 8).astype(np.float32),
             "depths": r.rand(b, 4, 4, 1).astype(np.float32),
             "input_ids": r.randint(0, 500, (b, 77)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("transport", [None, torch.bfloat16])
def test_prefetch_to_device_on_the_cpu(transport):
    batches = _batches()
    got = list(loader.prefetch_to_device(iter(batches), "cpu", transport_dtype=transport,
                                         transport_exempt=("depths",)))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert g["input_ids"].dtype == torch.int32 and g["depths"].dtype == torch.float32
        assert g["latent_moments"].dtype == (transport or torch.float32)
        for k, v in b.items():
            want = torch.from_numpy(v)
            if k == "latent_moments" and transport is not None:
                want = want.to(transport)
            assert torch.equal(g[k], want), k


def test_packed_upload_holds_the_cast_batch():
    """The card path packs a batch into one buffer (one copy); unpacked, each
    array is the CPU path's, 64-byte aligned."""
    batch = _batches(n=1)[0]
    batch["odd"] = np.arange(7, dtype=np.int64)
    flat, layout, size = loader._pack(batch, torch.bfloat16, ("depths",))
    want = loader._host_tensors(batch, torch.bfloat16, ("depths",))
    assert [k for k, *_ in layout] == list(batch) and size <= flat.numel()
    for k, offset, dtype, shape in layout:
        assert offset % 64 == 0
        assert torch.equal(loader._view(flat, offset, dtype, shape), want[k]), k
    again, _, _ = loader._pack(batch, torch.bfloat16, ("depths",), flat=flat)
    assert again is flat                     # a large enough buffer is reused


def test_prefetch_groups_and_stops_its_producer():
    batches = _batches(n=5)
    got = list(loader.prefetch_to_device(iter(batches), "cpu", group=2))
    assert [g["input_ids"].shape[0] for g in got] == [2, 2, 1]     # partial group kept
    assert torch.equal(got[1]["latent_moments"][1], torch.from_numpy(batches[3]["latent_moments"]))

    def endless():
        while True:
            yield batches[0]

    stream = loader.prefetch_to_device(endless(), "cpu")
    next(stream)
    stream.close()
    assert not any(t.name == "prefetch_to_device" for t in threading.enumerate())

    def broken():
        yield batches[0]
        raise OSError("unreadable sample")

    with pytest.raises(OSError, match="unreadable"):
        list(loader.prefetch_to_device(broken(), "cpu"))


def test_byte_vocab_matches_the_test_helpers(tmp_path):
    write_byte_vocab(str(tmp_path / "a"))
    write_char_tokenizer(str(tmp_path / "b"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
