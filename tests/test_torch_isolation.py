"""The PyTorch port stands alone: neither the package nor chip_smoke.py
imports jax, flax or the JAX package, and on CPU tensors the kernel wrappers
take their plain versions without launching (their counters stay 0)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "reflecting_reality_tpu_torch")
FORBIDDEN = ("jax", "flax", "reflecting_reality_tpu")


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports_in_source():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_imports_with_jax_blocked():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files()
    )
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + "".join(f"import {m}\n" for m in mods)
        + "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result, both
    in the checkout and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT), (str(alone), tmp_path)):
        res = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0 and '"ok"' not in res.stdout, (res.stdout, res.stderr)


def test_cpu_tensors_take_the_plain_versions():
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn
    from reflecting_reality_tpu_torch.ops.attention import dot_product_attention

    before = (fa.flash_attention_fwd.launches, gn.group_norm_silu_fwd.launches)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 4, 4)).astype(np.float32))
    w, b = torch.ones(8), torch.zeros(8)
    torch.testing.assert_close(gn.group_norm_silu(x, w, b, 4, 1e-5, True),
                               gn.group_norm_plain(x, w, b, 4, 1e-5, True), rtol=0, atol=0)
    q = torch.from_numpy(rng.standard_normal((1, 2048, 1, 8)).astype(np.float32))
    torch.testing.assert_close(fa.flash_attention(q, q, q), fa.attention_plain(q, q, q),
                               rtol=0, atol=0)
    torch.testing.assert_close(dot_product_attention(q, q, q), fa.attention_plain(q, q, q),
                               rtol=0, atol=0)
    assert (fa.flash_attention_fwd.launches, gn.group_norm_silu_fwd.launches) == before == (0, 0)
    assert not fa.flash_attention_fwd.launches_by_shape
    assert not gn.group_norm_silu_fwd.launches_by_shape
