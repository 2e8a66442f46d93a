"""Weight I/O of the PyTorch port: the JAX-tree bridge, strict loads, and
loading folders the JAX package writes.  Weights move without arithmetic, so
every comparison here is exact."""

import functools
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.core.io import flax_to_torch_state, save_pretrained
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu_torch.core.io import (
    WeightMappingError,
    cast_floating,
    convert_deprecated_attention_keys,
    empty_module,
    load_into,
    load_pretrained,
    load_safetensors,
    save_safetensors,
    state_dict_from_jax_params,
)
from reflecting_reality_tpu_torch.core.io import save_pretrained as t_save_pretrained
from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.tiny_checkpoint import TINY_UNET, make_tiny_sd_checkpoint
from tests.test_torch_helpers import TINY, TINY_TEXT, TINY_VAE

Z8, T1, EHS = jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 32))

CASES = {
    # name: (jax module, init args, port module factory, tensor count)
    "unet": (JUNet(sample_size=8, **TINY), (Z8, T1, EHS),
             lambda: UNet2DConditionModel(sample_size=8, **TINY), 684),
    "brushnet": (JBrushNet(conditioning_channels=6, **TINY),
                 (Z8, T1, EHS, jnp.zeros((1, 8, 8, 6))),
                 lambda: BrushNetModel(conditioning_channels=6, **TINY), 320),
    "vae": (JVAE(**TINY_VAE), (jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(9)),
            lambda: AutoencoderKL(**TINY_VAE), None),
    "clip": (JCLIP(**TINY_TEXT), (jnp.zeros((1, 77), jnp.int32),),
             lambda: CLIPTextModel(**TINY_TEXT), None),
}


@functools.lru_cache(maxsize=None)
def _params(name):
    jm, args, _, _ = CASES[name]
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_matches_flax_to_torch_state_and_loads_strictly(name):
    params = _params(name)
    ref = flax_to_torch_state(params["params"])
    got = state_dict_from_jax_params(params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    count = CASES[name][3]
    assert count is None or len(got) == count
    module = load_into(CASES[name][2](), got)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_dropped_key_raises():
    state = state_dict_from_jax_params(_params("unet"))
    state.pop("down_blocks.0.resnets.0.conv1.weight")
    with pytest.raises(WeightMappingError, match="missing from checkpoint"):
        load_into(UNet2DConditionModel(sample_size=8, **TINY), state)
    state = state_dict_from_jax_params(_params("unet"))
    state["conv_in.weight"] = state["conv_in.weight"][:, :2]
    with pytest.raises(WeightMappingError, match="shape mismatch"):
        load_into(UNet2DConditionModel(sample_size=8, **TINY), state)


def test_deprecated_vae_attention_names_load():
    """Old-vintage query/key/value/proj_attn keys, with (C, C, 1, 1) conv
    kernels, load into to_q/to_k/to_v/to_out.0."""
    state = state_dict_from_jax_params(_params("vae"))
    old = {}
    renames = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    for k, v in state.items():
        for new, dep in renames.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{dep}.")
                if k.endswith("weight"):
                    v = v[:, :, None, None]
        old[k] = v
    assert any(".query." in k for k in old)
    module = load_into(AutoencoderKL(**TINY_VAE), convert_deprecated_attention_keys(old))
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    """The tiny SD checkpoint written by the JAX package."""
    return make_tiny_sd_checkpoint(str(tmp_path_factory.mktemp("base")))


def test_from_pretrained_loads_jax_written_folders(jax_base, tmp_path):
    base = jax_base
    jb = JBrushNet(conditioning_channels=6, **{k: v for k, v in TINY_UNET.items()
                                               if k != "sample_size"})
    bparams = jb.init(jax.random.PRNGKey(1), Z8, T1, EHS, jnp.zeros((1, 8, 8, 6)))
    bdir = str(tmp_path / "brushnet")
    save_pretrained(jb, bparams["params"], bdir)

    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        base, bdir, depth_conditioning_mode="concat", device="cpu")
    ref = flax_to_torch_state(jax.tree_util.tree_map(np.asarray, bparams["params"]))
    got = pipe.brushnet.state_dict()
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["conv_in_condition.weight"].numpy(),
                                  ref["conv_in_condition.weight"])
    assert os.path.isdir(os.path.join(base, "tokenizer"))
    rng = np.random.RandomState(0)
    out = pipe("a mirror", rng.rand(64, 64, 3).astype(np.float32),
               np.ones((64, 64, 3), np.float32), depth=rng.rand(64, 64, 1).astype(np.float32),
               num_inference_steps=1, seed=0)
    assert out.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    assert isinstance(pipe.unet.conv_in.weight, torch.nn.Parameter)


# ------------------------------------------------------------ safetensors

def _st_tensors(seed=0):
    r = np.random.RandomState(seed)
    return {
        "w.f32": torch.from_numpy(r.randn(3, 5).astype(np.float32)),
        "w.f16": torch.from_numpy(r.randn(7).astype(np.float16)),
        "w.bf16": torch.from_numpy(r.randn(2, 3, 4).astype(np.float32)).to(torch.bfloat16),
        "w.i64": torch.from_numpy(r.randint(-9, 9, (4,)).astype(np.int64)),
        "w.i32": torch.from_numpy(r.randint(-9, 9, (1, 3)).astype(np.int32)),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_reader_matches_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load, save_file

    path = str(tmp_path / "ref.safetensors")
    save_file(_st_tensors(), path, metadata={"format": "pt"})
    got = load_safetensors(path)
    ref = torch_load(path)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].view(torch.int16) if v.dtype == torch.bfloat16 else got[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16 else v), k
    save_file({k: v for k, v in _st_tensors().items() if v.dtype != torch.bfloat16}, path)
    for k, v in np_load(path).items():
        np.testing.assert_array_equal(load_safetensors(path)[k].numpy(), v, err_msg=k)


def test_writer_is_read_back_by_the_safetensors_package(tmp_path):
    from safetensors.torch import load_file as torch_load

    path = str(tmp_path / "port.safetensors")
    tensors = _st_tensors(1)
    save_safetensors(tensors, path)
    ref = torch_load(path)
    assert sorted(ref) == sorted(tensors)
    for k, v in tensors.items():
        assert ref[k].dtype == v.dtype and torch.equal(ref[k], v), k
    # the port's own read of its file, and of a foreign file whose tensors
    # are not aligned for their dtype
    assert all(torch.equal(load_safetensors(path)[k], v) for k, v in tensors.items())
    header = b'{"a":{"dtype":"U8","shape":[3],"data_offsets":[0,3]},' \
             b'"b":{"dtype":"F32","shape":[2],"data_offsets":[3,11]}}'
    odd = tmp_path / "odd.safetensors"
    odd.write_bytes(struct.pack("<Q", len(header)) + header + b"\x01\x02\x03"
                    + np.array([1.5, -2.0], np.float32).tobytes())
    got = load_safetensors(str(odd))
    assert got["a"].tolist() == [1, 2, 3] and got["b"].tolist() == [1.5, -2.0]
    odd.write_bytes(odd.read_bytes()[:-1])
    with pytest.raises(ValueError, match="offsets"):
        load_safetensors(str(odd))


def test_loads_without_the_safetensors_package(jax_base, monkeypatch):
    for name in ("safetensors", "safetensors.torch", "safetensors.numpy"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    from reflecting_reality_tpu.core.io import load_pretrained as j_load

    unet = load_pretrained(UNet2DConditionModel, jax_base, subfolder="unet")
    ref = flax_to_torch_state(jax.tree_util.tree_map(
        np.asarray, j_load(JUNet, jax_base, subfolder="unet")[1]["params"]))
    for k, v in unet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert load_text_encoder(jax_base).text_model.final_layer_norm.weight.shape == (32,)


@pytest.mark.parametrize("name", ["unet", "brushnet", "vae"])
def test_folders_round_trip_through_both_packages(name, tmp_path):
    """JAX save_pretrained -> port load_pretrained -> port save_pretrained ->
    JAX load_pretrained gives the same params."""
    from reflecting_reality_tpu.core.io import load_pretrained as j_load

    jm = CASES[name][0]
    params = _params(name)
    save_pretrained(jm, params["params"], str(tmp_path / "jax"))
    module = load_pretrained(type(CASES[name][2]()), str(tmp_path / "jax"))
    t_save_pretrained(module, str(tmp_path / "port"))
    _, back = j_load(type(jm), str(tmp_path / "port"))
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = jax.tree_util.tree_leaves_with_path(back["params"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(p))


def test_cast_floating_and_empty_module():
    state = {"w": torch.ones(2), "ids": torch.arange(3)}
    cast = cast_floating(state, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    m = empty_module(AutoencoderKL, dict(TINY_VAE, _class_name="AutoencoderKL"))
    assert m.block_out_channels == TINY_VAE["block_out_channels"]
    assert all(p.device.type == "cpu" for p in m.parameters())
