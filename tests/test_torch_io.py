"""Weight I/O of the PyTorch port: the JAX-tree bridge, strict loads, and
loading folders the JAX package writes.  Weights move without arithmetic, so
every comparison here is exact."""

import os

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
    convert_deprecated_attention_keys,
    load_into,
    state_dict_from_jax_params,
)
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


def test_from_pretrained_loads_jax_written_folders(tmp_path):
    base = make_tiny_sd_checkpoint(str(tmp_path / "base"))
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
