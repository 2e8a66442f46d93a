"""Build and load the port's CUDA C++ kernels (plain C interface + ctypes).

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into
`_build/lib<name>-<hash>.so` beside this file (a directory .gitignore lists),
keyed by a hash of the source and the flags, so a rebuild happens only when
either changes.  Nothing is built when the module is imported: the first
`load` (the first kernel launch) builds.  The ptxas report (`-Xptxas -v`:
registers, shared memory, spills) is kept beside each library as `<lib>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

KERNEL_DIR = Path(__file__).resolve().parent
CSRC_DIR = KERNEL_DIR / "csrc"
BUILD_DIR = KERNEL_DIR / "_build"
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


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _build(name: str) -> Path:
    """Run nvcc for `csrc/<name>.cu` unless the library is built already;
    raise with nvcc's output on failure."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {lib.name}:\n{res.stdout}")
    lib.with_suffix(".log").write_text(res.stdout)
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(_build(name)))
    return _LOADED[name]
