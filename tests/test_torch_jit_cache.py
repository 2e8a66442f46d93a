"""Where the port builds its compiled libraries (`core/jit_cache.py`), on the
CPU: the kernel libraries' and the host transforms' directory follows
`enable_compilation_cache`, `RRTPU_COMPILE_CACHE` and every CLI's
`--compilation_cache_dir`, and goes back to the defaults afterwards (each
test restores the module's state).  Nothing is compiled here: nvcc builds
on the card (`chip_smoke.py`'s `compilation_cache` phase shows a second
process loading the libraries from the directory without nvcc)."""

import importlib

import pytest

import reflecting_reality_tpu_torch
from reflecting_reality_tpu_torch.core import jit_cache
from reflecting_reality_tpu_torch.data import native
from reflecting_reality_tpu_torch.ops.kernels import build
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def restore_cache_dir(monkeypatch):
    monkeypatch.setattr(jit_cache, "_CACHE_DIR", None)
    monkeypatch.delenv("RRTPU_COMPILE_CACHE", raising=False)
    yield
    monkeypatch.setattr(jit_cache, "_CACHE_DIR", None)


def test_build_directory_follows_the_cache(tmp_path):
    assert build.build_dir() == build.DEFAULT_BUILD_DIR
    assert build.library_path("groupnorm").parent == build.DEFAULT_BUILD_DIR
    assert native.library_path().parent == native.DEFAULT_BUILD_DIR
    jit_cache.enable_compilation_cache(None)          # JAX's no-op
    assert jit_cache.cache_dir() is None
    d = tmp_path / "cache"
    jit_cache.enable_compilation_cache(str(d))
    assert d.is_dir() and build.build_dir() == d
    for name in ("flash_attn_fwd", "flash_attn_bwd", "groupnorm"):
        lib = build.library_path(name)
        assert lib.parent == d and lib.name.startswith(f"lib{name}-")
    assert native.library_path().parent == d
    assert reflecting_reality_tpu_torch.enable_compilation_cache is (
        jit_cache.enable_compilation_cache)


def test_default_cache_reads_the_environment(tmp_path, monkeypatch):
    assert jit_cache.enable_default_compilation_cache() == str(build.DEFAULT_BUILD_DIR)
    assert build.build_dir() == build.DEFAULT_BUILD_DIR
    monkeypatch.setenv("RRTPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert jit_cache.enable_default_compilation_cache() == str(tmp_path / "env")
    assert build.build_dir() == tmp_path / "env"


CLIS = {
    "train": ["--pretrained_model_name_or_path", "/nonexistent", "--train_data_dir",
              "/nonexistent"],
    "test": ["--brushnet_path", "/nonexistent", "--train_data_dir", "/nonexistent"],
    "test_baseline": ["--brushnet_path", "/nonexistent", "--train_data_dir", "/nonexistent"],
    "serve": ["--base_model_path", "/nonexistent", "--brushnet_path", "/nonexistent"],
}


@pytest.mark.parametrize("cli", list(CLIS))
def test_every_cli_takes_the_flag(cli, tmp_path):
    """Each CLI points the build directory at the flag's before it reads
    anything (each run here then fails on its missing inputs)."""
    mod = importlib.import_module(f"reflecting_reality_tpu_torch.cli.{cli}")
    d = tmp_path / "cache"
    with pytest.raises((OSError, ValueError, RuntimeError)):
        mod.main([*CLIS[cli], "--compilation_cache_dir", str(d), "--device", "cpu"])
    assert build.build_dir() == d
