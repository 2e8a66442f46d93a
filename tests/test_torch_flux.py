"""The port's FLUX.1 Fill path against the benchmark's plain reference
(`bench_h100/reference/flux.py`), on the CPU in fp32 at a tiny size:
hidden 64 (2 heads x 32, RoPE axes 8/12/12), one double-stream and two
single-stream blocks, 384 input channels, a 2-layer T5 and CLIP, a 4-level
16-channel VAE, 64² images.  The weights are drawn by the benchmark's
`weights_flux.fill` into the port's modules and loaded strictly into the
reference's by name, so the two share every diffusers/transformers name.

Tolerances:
- a transformer forward, the VAE and the text encoders: 1e-5 of the
  output's largest value (fp32 both sides; the two sum in other orders and
  the rotary tables round once to fp32 on both);
- the whole 3-step Fill call: the uint8 image within 1 level (a value on a
  rounding boundary), and at most 0.1% of the values off at all;
- packing, ids and sigmas: exact (index arithmetic; the same float64 closed
  form rounded once to fp32, compared at 1e-7 relative).

The SD-1.5 and SDXL modules that FLUX shares (`vae.py`, `clip_text.py`)
are held bitwise to the equations they computed before FLUX's flags and
the pooled output were added.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from bench_h100 import weights_flux
from bench_h100.reference import flux as rf
from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.core.io import WeightMappingError, save_safetensors
from reflecting_reality_tpu_torch.data.tokenizer import (
    HashTokenizer, T5HashTokenizer, write_byte_vocab,
)
from reflecting_reality_tpu_torch.models.clip_text import (
    CLIPTextModel, CLIPTextModelWithProjection,
)
from reflecting_reality_tpu_torch.models.flux_transformer import FluxTransformer2DModel
from reflecting_reality_tpu_torch.models.t5 import T5EncoderModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from reflecting_reality_tpu_torch.ops import attention
from reflecting_reality_tpu_torch.ops.rotary import apply_rope, rope_tables
from reflecting_reality_tpu_torch.pipelines import FluxFillPipeline
from reflecting_reality_tpu_torch.pipelines.flux_fill_pipeline import (
    image_ids, pack_latents, pack_mask, unpack_latents,
)
from reflecting_reality_tpu_torch.schedulers.flow_match import calculate_shift, flow_match_sigmas
from tests.test_torch_helpers import TINY_TEXT, TINY_VAE, one_torch_thread  # noqa: F401

CFG = {
    "transformer": dict(in_channels=384, out_channels=64, num_layers=1, num_single_layers=2,
                        attention_head_dim=32, num_attention_heads=2, joint_attention_dim=32,
                        pooled_projection_dim=24, guidance_embeds=True,
                        axes_dims_rope=[8, 12, 12]),
    "t5": dict(vocab_size=1000, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
               relative_attention_num_buckets=32, relative_attention_max_distance=128,
               layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu"),
    "clip": dict(vocab_size=1000, hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=48, max_position_embeddings=77),
    "vae": dict(in_channels=3, out_channels=3, block_out_channels=[8, 8, 8, 16],
                layers_per_block=1, latent_channels=16, norm_num_groups=4,
                scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
                use_post_quant_conv=False, sample_size=64),
}
CLASSES = {"transformer": FluxTransformer2DModel, "t5": T5EncoderModel, "clip": CLIPTextModel,
           "vae": AutoencoderKL}
MAX_LEN = 24
PROMPT = "a framed mirror on the wall of a bright room"


def close(a, b, rel=1e-5):
    a, b = a.float(), b.float()
    assert (a - b).abs().max().item() <= rel * b.abs().max().item()


def port_module(kind: str, seed: int = 11):
    with torch.device("meta"):
        m = CLASSES[kind].from_config(CFG[kind])
    return weights_flux.fill(kind, m, seed, "cpu", torch.float32,
                             d_kv=CFG[kind].get("d_kv", 0)).eval()


def reference_of(kind: str, module):
    ref = rf.build(kind, CFG[kind])
    state = dict(module.state_dict())
    state.pop("encoder.embed_tokens.weight", None)        # T5's tied copy of `shared`
    ref.load_state_dict(state, strict=True)
    return ref.eval()


@pytest.fixture(scope="module")
def mods():
    port = {k: port_module(k) for k in CLASSES}
    return port, {k: reference_of(k, m) for k, m in port.items()}


def pipeline(port):
    return FluxFillPipeline(port["transformer"], port["vae"], port["clip"], port["t5"],
                            HashTokenizer(vocab_size=1000), T5HashTokenizer(1000, MAX_LEN),
                            device="cpu", max_sequence_length=MAX_LEN)


def request(seed: int = 0):
    rng = np.random.default_rng(seed)
    image = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[10:41, 18:50] = 255
    noise = torch.randn(1, 16, 8, 8, generator=torch.Generator().manual_seed(seed + 1))
    return image, mask, noise


@torch.no_grad()
def test_transformer_forward_matches_the_reference(mods):
    port, ref = mods
    g = torch.Generator().manual_seed(3)
    x, ctx = torch.randn(1, 16, 384, generator=g), torch.randn(1, 7, 32, generator=g)
    pooled = torch.randn(1, 24, generator=g)
    sigma, guide = torch.tensor([0.73]), torch.tensor([30.0])
    img, txt = rf.img_ids(4, 4, "cpu"), torch.zeros(7, 3)
    before = attention.routes.copy()
    out = port["transformer"](x, ctx, pooled, sigma, img, txt, guide)
    close(out, ref["transformer"](x, ctx, pooled, sigma, guide, img, txt))
    assert out.shape == (1, 16, 64)
    # 1 double + 2 single joint attentions, all plain on CPU tensors
    assert attention.routes - before == {"plain": 3}


def test_transformer_takes_diffusers_names(mods):
    names = set(mods[0]["transformer"].state_dict())
    for n in ("x_embedder.weight", "context_embedder.bias", "proj_out.weight",
              "norm_out.linear.weight", "time_text_embed.timestep_embedder.linear_1.weight",
              "time_text_embed.guidance_embedder.linear_2.bias",
              "time_text_embed.text_embedder.linear_1.weight",
              "transformer_blocks.0.norm1.linear.weight",
              "transformer_blocks.0.norm1_context.linear.bias",
              "transformer_blocks.0.attn.norm_added_k.weight",
              "transformer_blocks.0.attn.to_out.0.weight",
              "transformer_blocks.0.attn.to_add_out.bias",
              "transformer_blocks.0.ff.net.0.proj.weight",
              "transformer_blocks.0.ff_context.net.2.weight",
              "single_transformer_blocks.1.norm.linear.weight",
              "single_transformer_blocks.1.attn.norm_q.weight",
              "single_transformer_blocks.1.proj_mlp.bias",
              "single_transformer_blocks.1.proj_out.weight"):
        assert n in names, n
    assert not any("single_transformer_blocks.0.attn.to_out" in n for n in names)
    assert mods[0]["transformer"].single_transformer_blocks[0].proj_out.in_features == 5 * 64


@torch.no_grad()
def test_norm_out_modulation_is_scale_then_shift():
    """AdaLayerNormContinuous's chunks are (scale, shift), the reverse of
    the AdaLayerNormZero order: a bias of (scale 1, shift 0.5) gives
    2 LN(x) + 0.5."""
    m = port_module("transformer")
    lin = m.norm_out.linear
    lin.weight.zero_()
    lin.bias.copy_(torch.cat([torch.ones(64), torch.full((64,), 0.5)]))
    x, temb = torch.randn(1, 5, 64), torch.randn(1, 64)
    expect = torch.nn.functional.layer_norm(x, (64,), eps=1e-6) * 2 + 0.5
    torch.testing.assert_close(m.norm_out(x, temb), expect)


@torch.no_grad()
def test_rotary_embedding_turns_adjacent_pairs():
    """Against the complex form: channel pair (2j, 2j+1) of axis a is the
    complex number x_2j + i x_2j+1 times exp(i pos_a theta^(-2j/dim_a))."""
    axes = [4, 6, 6]
    ids = torch.tensor([[0.0, 0.0, 0.0], [0.0, 3.0, 5.0], [0.0, 7.0, 1.0]])
    x = torch.randn(1, 3, 2, 16, dtype=torch.float64).float()
    cos, sin = rope_tables(ids, axes)
    got = apply_rope(x, cos, sin)
    angles = torch.cat([ids[:, a:a + 1].double() * 10000.0 ** (
        -torch.arange(0, d, 2, dtype=torch.float64) / d) for a, d in enumerate(axes)], dim=1)
    z = torch.view_as_complex(x.double().reshape(1, 3, 2, 8, 2).contiguous())
    want = torch.view_as_real(z * torch.polar(torch.ones_like(angles), angles)[None, :, None])
    torch.testing.assert_close(got.double(), want.reshape(1, 3, 2, 16), atol=1e-6, rtol=0)
    c2, s2 = rf.rope_tables(ids, axes)
    assert torch.equal(cos, c2) and torch.equal(sin, s2)


def test_packing_its_inverse_and_the_mask():
    x = torch.arange(2 * 16 * 6 * 4, dtype=torch.float32).reshape(2, 16, 6, 4)
    p = pack_latents(x)
    assert p.shape == (2, 6, 64)
    # token (row r, col c), channel ch*4 + 2 dy + dx is x[:, ch, 2r + dy, 2c + dx]
    for r, c, ch, dy, dx in ((0, 0, 0, 0, 1), (2, 1, 5, 1, 0), (1, 1, 15, 1, 1)):
        assert torch.equal(p[:, r * 2 + c, ch * 4 + 2 * dy + dx], x[:, ch, 2 * r + dy, 2 * c + dx])
    assert torch.equal(unpack_latents(p, 6, 4), x)
    assert torch.equal(p, rf.pack(x)) and torch.equal(rf.unpack(p, 6, 4), x)
    mask = (torch.rand(1, 32, 48, generator=torch.Generator().manual_seed(0)) > 0.5).float()
    pm = pack_mask(mask)
    assert pm.shape == (1, 2 * 3, 256)
    # latent pixel (y, x)'s 8x8 block: channel (dy * 8 + dx) * 4 + 2 sy + sx
    for y, xx, dy, dx in ((1, 2, 3, 6), (0, 5, 7, 0), (3, 4, 0, 1)):
        tok, ch = (y // 2) * 3 + xx // 2, (dy * 8 + dx) * 4 + 2 * (y % 2) + (xx % 2)
        assert pm[0, tok, ch] == mask[0, 8 * y + dy, 8 * xx + dx]
    assert torch.equal(image_ids(3, 2, "cpu"), rf.img_ids(3, 2, "cpu"))
    assert image_ids(3, 2, "cpu")[5].tolist() == [0.0, 2.0, 1.0]


def test_flow_match_sigmas_are_the_shifted_linspace():
    assert calculate_shift(4096) == pytest.approx(1.15)
    assert calculate_shift(256) == pytest.approx(0.5)
    s = flow_match_sigmas(50, 4096)
    assert s.dtype == np.float32 and s.shape == (51,) and s[-1] == 0.0 and s[0] == 1.0
    mu = 1.15
    for k in (1, 10, 49):
        lin = 1.0 - k * (1.0 - 1.0 / 50) / 49
        assert s[k] == pytest.approx(math.exp(mu) / (math.exp(mu) + 1.0 / lin - 1.0), rel=1e-7)
    assert np.all(np.diff(s) < 0)
    np.testing.assert_array_equal(s, rf.sigmas(50, 4096))
    np.testing.assert_array_equal(flow_match_sigmas(3, 16), rf.sigmas(3, 16))


def test_t5_hash_tokenizer_is_the_reference_s():
    ids = T5HashTokenizer(32128, 512)([PROMPT, ""])
    assert ids.shape == (2, 512) and ids[1, 0] == 1 and not ids[1, 1:].any()
    assert ids[0, len(PROMPT.split())] == 1 and ids[0, :len(PROMPT.split())].min() >= 2
    np.testing.assert_array_equal(ids, rf.t5_hash_tokens([PROMPT, ""], 32128, 512))


@torch.no_grad()
def test_vae_and_clip_pooled_match_the_reference(mods):
    port, ref = mods
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(5))
    close(port["vae"].encode(x).mean, ref["vae"].encode_mean(x))
    z = torch.randn(1, 16, 8, 8, generator=torch.Generator().manual_seed(6))
    close(port["vae"].decode(z), ref["vae"].decode(z))
    assert port["vae"].quant_conv is None and port["vae"].post_quant_conv is None
    ids = torch.as_tensor(HashTokenizer(1000)([PROMPT, "mirror"]), dtype=torch.long)
    close(port["clip"].pooled_output(ids), ref["clip"](ids))


@torch.no_grad()
def test_fill_call_matches_the_reference(mods):
    port, ref = mods
    image, mask, noise = request()
    pipe = pipeline(port)
    tracing.enable()
    try:
        out = pipe(prompt=PROMPT, image=image[None], mask=mask[None, ..., None],
                   num_inference_steps=3, latents=noise.permute(0, 2, 3, 1),
                   deterministic_vae_encode=True)
        spans = {s["name"] for s in tracing.take()["spans"]}
    finally:
        tracing.disable()
    want = rf.generate(ref, CFG, PROMPT, image.astype(np.float32) / 255.0,
                       (mask > 0).astype(np.float32), noise, 3, 30.0, MAX_LEN).numpy()
    d = np.abs(out[0].astype(int) - want.astype(int))
    assert out.shape == (1, 64, 64, 3) and d.max() <= 1 and (d > 0).mean() < 1e-3
    assert {"rr.pipeline.call", "rr.pipeline.text", "rr.t5", "rr.pipeline.conditioning",
            "rr.pipeline.denoise", "rr.pipeline.step", "rr.transformer", "rr.flux.double",
            "rr.flux.single", "rr.pipeline.scheduler", "rr.pipeline.decode",
            "rr.pipeline.output"} <= spans
    st = pipe.stats()
    assert st["calls"] == 1 and st["steps"] == 3 and st["joint_tokens"] == 16 + MAX_LEN
    assert st["attention"] == {"joint": {"flash": 0, "plain": 9}, "text": {"plain": 4},
                               "vae": {"plain": 2}}


@torch.no_grad()
def test_the_masked_image_is_image_times_one_minus_the_mask(mods):
    """The conditioning's latent half is the VAE mean of image x (1 - mask):
    the hole's pixels do not reach it."""
    pipe = pipeline(mods[0])
    image, mask, _ = request(4)
    other = image.copy()
    other[mask > 0] = 255 - other[mask > 0]
    conds = [pipe._latents_and_conditioning(im[None], mask[None, ..., None], None, None, 1,
                                            torch.Generator().manual_seed(0), None, True)[1]
             for im in (image, other)]
    assert torch.equal(conds[0], conds[1])
    assert conds[0].shape == (1, 16, 64 + 256)
    np.testing.assert_array_equal(conds[0][0, :, 64:].sum(-1).numpy(),
                                  pack_mask(torch.as_tensor(mask[None] > 0).float())[0].sum(-1))


@pytest.mark.parametrize("vae_cfg", [TINY_VAE, dict(TINY_VAE, scaling_factor=0.13025)],
                         ids=["sd15", "sdxl"])
@torch.no_grad()
def test_the_sd_vae_keeps_its_quant_convs_bitwise(vae_cfg):
    torch.manual_seed(0)
    vae = AutoencoderKL(**vae_cfg).eval()
    assert {"quant_conv.weight", "post_quant_conv.bias"} <= set(vae.state_dict())
    assert vae.shift_factor is None
    x, z = torch.randn(1, 3, 32, 32), torch.randn(1, 4, 4, 4)
    old = DiagonalGaussian.from_moments(vae.quant_conv(vae.encoder(x)))
    new = vae.encode(x)
    assert torch.equal(new.mean, old.mean) and torch.equal(new.logvar, old.logvar)
    assert torch.equal(vae.decode(z), vae.decoder(vae.post_quant_conv(z)))


@torch.no_grad()
def test_clip_towers_unchanged_by_the_pooled_output():
    torch.manual_seed(0)
    clip, big = CLIPTextModel(**TINY_TEXT).eval(), CLIPTextModelWithProjection(
        **dict(TINY_TEXT, projection_dim=8, eos_token_id=999)).eval()
    ids = torch.as_tensor(HashTokenizer(1000)([PROMPT, "a"]), dtype=torch.long)
    last, states = clip.text_model(ids)
    assert torch.equal(clip(ids), last)
    assert torch.equal(clip.pooled_output(ids), last[torch.arange(2), ids.argmax(1)])
    blast, _ = big.text_model(ids)
    out_last, pooled = big(ids)
    assert torch.equal(out_last, blast)
    assert torch.equal(pooled, big.text_projection(blast[torch.arange(2), (ids == 999).int()
                                                         .argmax(1)]))


def _write(folder, module, name, shards: int = 1):
    os.makedirs(folder, exist_ok=True)
    module.save_config(folder)
    state = module.state_dict()
    if shards == 1:
        save_safetensors(state, os.path.join(folder, name))
        return
    keys, weight_map = sorted(state), {}
    for i in range(shards):
        shard = name.replace(".safetensors", f"-{i + 1:05d}-of-{shards:05d}.safetensors")
        part = {k: state[k] for k in keys[i::shards]}
        save_safetensors(part, os.path.join(folder, shard))
        weight_map.update(dict.fromkeys(part, shard))
    with open(os.path.join(folder, name + ".index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@torch.no_grad()
def test_from_pretrained_loads_a_diffusers_folder_strictly(mods, tmp_path):
    port = mods[0]
    root = str(tmp_path)
    _write(os.path.join(root, "transformer"), port["transformer"],
           "diffusion_pytorch_model.safetensors", shards=2)
    _write(os.path.join(root, "vae"), port["vae"], "diffusion_pytorch_model.safetensors")
    _write(os.path.join(root, "text_encoder"), port["clip"], "model.safetensors")
    t5_state = {k: v for k, v in port["t5"].state_dict().items()
                if k != "encoder.embed_tokens.weight"}           # transformers drops the tie
    os.makedirs(os.path.join(root, "text_encoder_2"))
    port["t5"].save_config(os.path.join(root, "text_encoder_2"))
    save_safetensors(t5_state, os.path.join(root, "text_encoder_2", "model.safetensors"))
    write_byte_vocab(os.path.join(root, "tokenizer"))
    loaded = FluxFillPipeline.from_pretrained(root, dtype=torch.float32, device="cpu",
                                              tokenizer=HashTokenizer(1000),
                                              tokenizer_2=T5HashTokenizer(1000, MAX_LEN))
    for name, kind in (("transformer", "transformer"), ("vae", "vae"), ("text_encoder", "clip"),
                       ("text_encoder_2", "t5")):
        got, want = getattr(loaded, name).state_dict(), port[kind].state_dict()
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert loaded.shift_factor == pytest.approx(0.1159)
    image, mask, noise = request(2)
    kw = dict(prompt=PROMPT, image=image[None], mask=mask[None, ..., None],
              num_inference_steps=2, latents=noise.permute(0, 2, 3, 1),
              deterministic_vae_encode=True)
    np.testing.assert_array_equal(loaded(**kw), pipeline(port)(**kw))
    os.remove(os.path.join(root, "vae", "config.json"))
    port["vae"].save_config(os.path.join(root, "vae"))
    state = port["vae"].state_dict()
    state.pop("decoder.conv_in.bias")
    save_safetensors(state, os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    with pytest.raises(WeightMappingError, match="decoder.conv_in.bias"):
        FluxFillPipeline.from_pretrained(root, dtype=torch.float32, device="cpu")
