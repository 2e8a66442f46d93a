"""Tiny configurations and cells for the CPU tests of the FLUX.1 Fill cell
and the saturated serving cell: the configurations' layout at small widths,
short cells on the CPU."""

from __future__ import annotations

import copy

from bench_h100 import harness


def config(dtype: str = "float32") -> dict:
    """FLUX.1 Fill's layout at small widths: hidden 64 (2 heads x 32, RoPE
    axes 8/12/12), one double and two single blocks, 384 input channels, a
    2-layer T5 and CLIP, a 4-level 16-channel VAE, 16 T5 tokens."""
    cfg = copy.deepcopy(harness.load_config("flux1-fill-dev"))
    cfg.update(
        dtype=dtype, max_sequence_length=16,
        transformer=dict(cfg["transformer"], num_layers=1, num_single_layers=2,
                         attention_head_dim=32, num_attention_heads=2, joint_attention_dim=32,
                         pooled_projection_dim=24, axes_dims_rope=[8, 12, 12]),
        t5=dict(cfg["t5"], vocab_size=1000, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                num_heads=4),
        clip=dict(cfg["clip"], vocab_size=1000, hidden_size=24, intermediate_size=48,
                  num_hidden_layers=2, num_attention_heads=2),
        vae=dict(cfg["vae"], block_out_channels=[8, 8, 8, 16], layers_per_block=1,
                 norm_num_groups=4, sample_size=64))
    return cfg


def cell(name: str, **params) -> dict:
    c = copy.deepcopy(harness.load_cell(name))
    c["params"].update(params)
    return c


FLUX = dict(resolution=64, num_inference_steps=3, requests=3, check_requests=2, check_steps=3,
            trace_offset_s=0.0, trace_steps=3)
SATURATED = dict(resolution=64, num_inference_steps=3, callers=3, requests=40, max_batch=2,
                 check_requests=2, tail_s=1.0, trace_offset_s=0.5, trace_seconds=1.0)
