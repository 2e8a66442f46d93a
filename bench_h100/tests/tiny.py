"""Tiny configurations and cells for the CPU tests: the configuration's
layout at small widths, and short cells on the CPU."""

from __future__ import annotations

import copy

from bench_h100 import harness

UNET = {"sample_size": 8, "in_channels": 4, "out_channels": 4,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "mid_block_type": "UNetMidBlock2DCrossAttn",
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
        "block_out_channels": [32, 64], "layers_per_block": 1,
        "transformer_layers_per_block": 1, "downsample_padding": 1, "norm_num_groups": 8,
        "norm_eps": 1e-05, "cross_attention_dim": 32, "attention_head_dim": 2,
        "use_linear_projection": False, "flip_sin_to_cos": True, "freq_shift": 0}


def config(dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(harness.load_config("sd15-mirrorfusion"))
    brush = dict(UNET, conditioning_channels=6, down_block_types=["DownBlock2D"] * 2,
                 mid_block_type="MidBlock2D", up_block_types=["UpBlock2D"] * 2)
    brush.pop("sample_size")
    brush.pop("out_channels")
    cfg.update(dtype=dtype, unet=dict(UNET), brushnet=brush,
               vae={"in_channels": 3, "out_channels": 3, "block_out_channels": [8, 8, 8, 16],
                    "layers_per_block": 1, "latent_channels": 4, "norm_num_groups": 4,
                    "scaling_factor": 0.18215, "sample_size": 64},
               text_encoder={"vocab_size": 1000, "hidden_size": 32, "num_hidden_layers": 2,
                             "num_attention_heads": 2, "intermediate_size": 64,
                             "max_position_embeddings": 77})
    return cfg


def cell(name: str, **params) -> dict:
    c = copy.deepcopy(harness.load_cell(name))
    c["params"].update(params)
    return c


SERVE = dict(resolution=64, num_inference_steps=3, rate=2.0, check_requests=2,
             trace_offset_s=0.5, trace_seconds=1.0)
TRAIN = dict(resolution=64, samples=16, trace_offset_s=0.0, trace_steps=2)


def config_xl(dtype: str = "float32") -> dict:
    """The SDXL configuration's layout at small widths: text_time
    embeddings, linear projections, two text encoders."""
    cfg = copy.deepcopy(harness.load_config("sdxl-brushnet"))
    unet = dict(UNET, use_linear_projection=True, cross_attention_dim=64,
                addition_embed_type="text_time", addition_time_embed_dim=8,
                projection_class_embeddings_input_dim=32 + 6 * 8,
                transformer_layers_per_block=[1, 2], attention_head_dim=[2, 4])
    brush = dict(unet, conditioning_channels=6, down_block_types=["DownBlock2D"] * 2,
                 mid_block_type="MidBlock2D", up_block_types=["UpBlock2D"] * 2)
    brush.pop("sample_size")
    brush.pop("out_channels")
    small = config(dtype)
    cfg.update(dtype=dtype, unet=unet, brushnet=brush, vae=dict(small["vae"], scaling_factor=0.13025),
               text_encoder=small["text_encoder"],
               text_encoder_2=dict(small["text_encoder"], projection_dim=32, eos_token_id=999))
    return cfg


CLOSED = dict(resolution=64, num_inference_steps=3, requests=3, check_requests=2,
              trace_offset_s=0.0, trace_steps=3)
