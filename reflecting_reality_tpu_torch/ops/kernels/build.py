"""Build and load the port's CUDA C++ kernels (plain C interface + ctypes).

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into
`lib<name>-<hash>.so` in `build_dir()`: `_build/` beside this file (a
directory .gitignore lists) unless `core.jit_cache.enable_compilation_cache`
(`--compilation_cache_dir`) named another.  Libraries are keyed by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags, so a rebuild
happens only when one of them changes.  Nothing is built when the module is
imported: the first `load` (the first kernel launch) builds.  The ptxas report (`-Xptxas -v`:
registers, shared memory, spills) is kept beside each library as `<lib>.log`.

A fake tensor (`torch._subclasses.fake_tensor.FakeTensor`, the memory plan of
`tools/aot_memory.py`) holds no data: the kernel wrappers give it outputs of
the right shape and dtype and neither build, launch nor count (`is_fake`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from torch._subclasses.fake_tensor import FakeTensor

from reflecting_reality_tpu_torch.core import jit_cache

KERNEL_DIR = Path(__file__).resolve().parent
CSRC_DIR = KERNEL_DIR / "csrc"
DEFAULT_BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build_dir() -> Path:
    """Where the libraries are built and loaded from."""
    return jit_cache.cache_dir() or DEFAULT_BUILD_DIR


def is_fake(x) -> bool:
    """x is a fake tensor: shapes and dtypes, no data (a memory plan)."""
    return isinstance(x, FakeTensor)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str) -> Path:
    """Run nvcc for `csrc/<name>.cu` unless the library is built already;
    raise with nvcc's output on failure."""
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {lib.name}:\n{res.stdout}")
    lib.with_suffix(".log").write_text(res.stdout)
    os.replace(tmp, lib)
    return lib


def launch(fn, device, *args) -> int:
    """fn(*args, stream) with the current stream of `device` (a torch.device)
    and that device current -> fn's cudaError_t.  The device is switched only
    when it is not current, and the stream is read as a raw handle:
    `torch.cuda.current_stream()` builds a Python Stream object at every
    call, several microseconds of host time at each of a denoise step's 105
    GroupNorm launches."""
    import torch

    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(_build(name)))
    return _LOADED[name]
