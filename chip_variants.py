#!/usr/bin/env python3
"""Variants of the fp32 flash backward (kernels B3 and B4) timed on one
NVIDIA GPU, to see what holds the kernels: each variant is a copy of
`reflecting_reality_tpu_torch/ops/kernels/csrc/` with one edit (a step
left out, another tiling, one TF32 pass), built by nvcc into its own
folder under the kernels' gitignored `_build/variants/`, run at
(2, 4096, 8, 40) fp32 in a process of its own and timed on the device
clock (`chip_smoke.graph_ms`: 20 launches in one CUDA graph), with its
largest error against `flash_attention_bwd_plain` over each gradient's max.
A variant that leaves a step out computes wrong gradients: only its time
means something.

    python3 chip_variants.py            # every variant, "base" first and last
    python3 chip_variants.py NAME ...   # the variants named, in that order

Prints one JSON line per kernel and variant.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
SHAPE = (2, 4096, 8, 40)
BWD = "flash_attn_bwd.cu"
COMMON = "flash_common.cuh"

# the producer's per-tile work as the source has it
B3_T = "        transpose_tile<DP, BN, true>(kh + st * TB, kl + st * TB, kth + st * TB, ktl + st * TB, t);\n"
B3_V_SPLIT = "        split_tile(vh + st * TB, vl + st * TB, BN * DP / 4, t);\n"
B4_T = ("        transpose_tile<DP, BQ, true>(qh + st * TB, ql + st * TB, qth + st * TB, qtl + st * TB, t);\n"
        "        transpose_tile<DP, BQ, true>(oh + st * TB, ol + st * TB, oth + st * TB, otl + st * TB, t);\n")
# ... and its variants: the split alone, the transpose alone, or both in two
# passes with a barrier between them
B3_K_SPLIT = "        split_tile(kh + st * TB, kl + st * TB, BN * DP / 4, t);\n"
B4_SPLITS = ("        split_tile(qh + st * TB, ql + st * TB, BQ * DP / 4, t);\n"
             "        split_tile(oh + st * TB, ol + st * TB, BQ * DP / 4, t);\n")
B3_T_ONLY = B3_T.replace("true>(kh + st * TB, kl + st * TB", "false>(kh + st * TB, nullptr")
B4_T_ONLY = (B4_T.replace("true", "false").replace("ql + st * TB", "nullptr")
             .replace("ol + st * TB", "nullptr"))
SYNC = "        hopper::named_sync<XF_THREADS>(3);\n"
ONE_PASS_ABT = '''#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(ah + c * M * SLAB_BYTES), kmajor(bl + c * N * SLAB_BYTES),
                             c > 0);
#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(al + c * M * SLAB_BYTES), kmajor(bh + c * N * SLAB_BYTES),
                             1);
#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(ah + c * M * SLAB_BYTES), kmajor(bh + c * N * SLAB_BYTES),
                             1);'''
ONE_PASS_AB = '''#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_lo[kk], kmajor(bh + kk * slab_bytes), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_hi[kk], kmajor(bl + kk * slab_bytes), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_hi[kk], kmajor(bh + kk * slab_bytes), 1);'''

B3_BN = "static constexpr int BN = DP <= 64 ? 32"
B3_STAGES = "static constexpr int STAGES = DP == 40 ? 4 : 2;"
B4_BQ = "static constexpr int BQ = DP == 40 ? 32"
B4_STAGES = "static constexpr int STAGES = DP == 64 ? 2 : DP == 160 ? 1 : 3;"

# name: [(file, text, its replacement)]; the tilings are those of DP = 40
VARIANTS = {
    "base": [],
    "b3_bn64_2stages": [(BWD, B3_BN, "static constexpr int BN = DP == 40 ? 64 : DP <= 64 ? 32"),
                        (BWD, B3_STAGES, "static constexpr int STAGES = 2;")],
    "b3_bn32_3stages": [(BWD, B3_STAGES, "static constexpr int STAGES = DP == 40 ? 3 : 2;")],
    "b3_bn16_4stages": [(BWD, B3_BN, "static constexpr int BN = DP == 40 ? 16 : DP <= 64 ? 32")],
    "b4_bq32_2stages": [(BWD, B4_STAGES, "static constexpr int STAGES = DP == 160 ? 1 : 2;")],
    "b4_bq16_4stages": [(BWD, B4_BQ, "static constexpr int BQ = DP == 40 ? 16"),
                        (BWD, B4_STAGES,
                         "static constexpr int STAGES = DP == 40 ? 4 : DP == 64 ? 2 : DP == 160 ? 1 : 3;")],
    "b4_bq16_6stages": [(BWD, B4_BQ, "static constexpr int BQ = DP == 40 ? 16"),
                        (BWD, B4_STAGES,
                         "static constexpr int STAGES = DP == 40 ? 6 : DP == 64 ? 2 : DP == 160 ? 1 : 3;")],
    "b3_no_transpose": [(BWD, B3_T, B3_K_SPLIT)],
    "b3_no_split": [(BWD, B3_T + B3_V_SPLIT, B3_T_ONLY)],
    "b4_no_transpose": [(BWD, B4_T, B4_SPLITS)],
    "b4_no_split": [(BWD, B4_T, B4_T_ONLY)],
    "split_apart": [(BWD, B3_T, B3_T_ONLY + SYNC + B3_K_SPLIT),
                    (BWD, B4_T, B4_T_ONLY + SYNC + B4_SPLITS)],
    "one_tf32_pass": [(COMMON, ONE_PASS_ABT, '''#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(ah + c * M * SLAB_BYTES), kmajor(bh + c * N * SLAB_BYTES),
                             c > 0);'''),
                      (COMMON, ONE_PASS_AB, '''#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_hi[kk], kmajor(bh + kk * slab_bytes), kk > 0);''')],
}


def run_one(name: str) -> None:
    import torch

    import chip_smoke as cs
    from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache
    from reflecting_reality_tpu_torch.ops.kernels import build
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    src = os.path.join(build.build_dir(), "variants", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, os.path.join(src, "csrc"))
    for fname, old, new in VARIANTS[name]:
        p = os.path.join(src, "csrc", fname)
        with open(p) as f:
            text = f.read()
        assert text.count(old) == 1, (name, old[:60])
        with open(p, "w") as f:
            f.write(text.replace(old, new))
    build.CSRC_DIR = Path(src) / "csrc"
    enable_compilation_cache(os.path.join(src, "_build"))
    g = torch.Generator("cuda").manual_seed(cs.SEED + 7)
    q, k, v, do = (torch.randn(SHAPE, generator=g, device="cuda") for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_delta(out, do)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for kernel, run, refs in (
            ("flash_attn_bwd_dq", lambda: (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),),
             ref[:1]),
            ("flash_attn_bwd_dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             ref[1:])):
        err = max(((a - r).abs().max() / r.abs().max()).item() for a, r in zip(run(), refs))
        print(json.dumps({"variant": name, "kernel": kernel, "shape": list(SHAPE),
                          "device_ms": cs.graph_ms(torch, run),
                          "max_abs_err_of_max": err}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        for name in sys.argv[1:] or list(VARIANTS) + ["base"]:
            subprocess.run([sys.executable, __file__, "--one", name], timeout=600)
