"""The reference stands alone: it imports neither JAX, nor the JAX
package, nor anything of the program, and runs with the program
unimportable; its modules carry the program's parameter names and shapes,
so the seeded weights land alike on both sides; and at a tiny size on the
CPU it computes what the program's plain paths compute."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny

REF = Path(harness.HERE / "reference")
ALLOWED = {"__future__", "math", "zlib", "typing", "numpy", "torch", "bench_h100"}


def test_reference_imports_only_torch_numpy_and_the_stdlib():
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top in ALLOWED, f"{path.name} imports {name}"
                if top == "bench_h100":
                    assert name.startswith("bench_h100.reference"), f"{path.name}: {name}"


def test_reference_runs_with_the_program_unimportable():
    code = """
import sys
for m in ("reflecting_reality_tpu_torch", "reflecting_reality_tpu", "jax"):
    sys.modules[m] = None
import numpy as np, torch
torch.set_num_threads(2)
from bench_h100 import weights
from bench_h100.reference import models, sampling, training
from bench_h100.tests import tiny
cfg = tiny.config()
mods = {}
for kind in ("unet", "brushnet", "vae", "text_encoder"):
    with torch.device("meta"):
        m = models.build(kind, cfg[kind])
    weights.fill(kind, m, 3, "cpu", torch.float32)
    mods[kind] = m
z = np.zeros((64, 64, 3), np.float32)
img = sampling.generate_sd15(mods, "a mirror", z, z, z[..., :1], 5, 2, 7.5, "cpu", 0.18215, 1000)
assert img.shape == (64, 64, 3) and img.dtype == torch.uint8
bad = [m for m in sys.modules if m.split(".")[0] in ("reflecting_reality_tpu_torch", "jax")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(harness.ROOT), timeout=600)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


@pytest.mark.parametrize("full", [False, True])
def test_parameter_names_and_shapes_match_the_programs(full):
    cfg = harness.load_config("sd15-mirrorfusion") if full else tiny.config()
    from bench_h100.reference.models import build
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    classes = {"unet": UNet2DConditionModel, "brushnet": BrushNetModel, "vae": AutoencoderKL,
               "text_encoder": CLIPTextModel}
    for kind, cls in classes.items():
        with torch.device("meta"):
            prog, ref = cls(**cfg[kind]), build(kind, cfg[kind])
        shapes = {n: tuple(p.shape) for n, p in prog.named_parameters()}
        assert shapes == {n: tuple(p.shape) for n, p in ref.named_parameters()}, kind
        assert not list(prog.buffers()), kind


def test_seeded_weights_are_the_same_on_both_sides():
    cfg = tiny.config()
    prog = harness.program_modules(cfg, 7, torch.device("cpu"), torch.bfloat16)
    ref = harness.reference_modules(cfg, 7, torch.device("cpu"), torch.float32)
    for kind in prog:
        p = dict(prog[kind].named_parameters())
        for n, q in ref[kind].named_parameters():
            assert torch.equal(p[n].float(), q), (kind, n)
    other = harness.reference_modules(cfg, 8, torch.device("cpu"), torch.float32)
    assert not torch.equal(other["unet"].conv_in.weight, ref["unet"].conv_in.weight)


def test_unet_and_brushnet_forward_agree_with_the_programs_plain_paths():
    cfg = tiny.config()
    dev = torch.device("cpu")
    prog = harness.program_modules(cfg, 9, dev, torch.float32)
    ref = harness.reference_modules(cfg, 9, dev, torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=g)
    cond = torch.randn(2, 6, 8, 8, generator=g)
    ctx = torch.randn(2, 77, 32, generator=g)
    t = torch.tensor([500, 20])
    with torch.no_grad():
        d, m, u = prog["brushnet"](x, t, ctx, cond)
        want = prog["unet"](x, t, ctx, down_block_add_samples=d, mid_block_add_sample=m,
                            up_block_add_samples=u)
        rd, rm, ru = ref["brushnet"](x, t, ctx, cond)
        got = ref["unet"](x, t, ctx, rd, rm, ru)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        img = torch.rand(1, 3, 64, 64, generator=g) * 2 - 1
        assert torch.allclose(ref["vae"].encode_moments(img)[0],
                              prog["vae"].encode(img).mean, atol=1e-5)
        z = torch.randn(1, 4, 8, 8, generator=g)
        assert torch.allclose(ref["vae"].decode(z), prog["vae"].decode(z), atol=1e-4)
        ids = torch.tensor([[1, 5, 9, 999] + [0] * 73])
        assert torch.allclose(ref["text_encoder"](ids)[0], prog["text_encoder"](ids), atol=1e-5)
