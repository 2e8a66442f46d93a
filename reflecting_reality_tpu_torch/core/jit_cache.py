"""Where the port's compiled artefacts go (counterpart of
`reflecting_reality_tpu/core/jit_cache.py`).

JAX's persistent compilation cache holds XLA programs.  The port compiles
no graphs; what it builds are the kernel libraries, each `csrc/<name>.cu`
built by nvcc into `lib<name>-<hash>.so` with its ptxas report `<lib>.log`
(`ops/kernels/build.py`), and the host transforms' `libtransforms-<hash>.so`
(g++, `data/native.py`).  Each is keyed by a hash of its sources and flags,
so a directory of them is a cache: a process that finds its library there
loads it without running the compiler.

By default each library is built beside its module (`ops/kernels/_build/`,
`data/_build/`, both listed in .gitignore).  `enable_compilation_cache(dir)`
(the `--compilation_cache_dir` flag of the CLIs) sends both to `dir`: a
read-only install, or machines that share a cache, can then put them
elsewhere.  It changes where the next build or load looks; a library
already loaded stays loaded.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_CACHE_DIR: Optional[Path] = None


def cache_dir() -> Optional[Path]:
    """The directory set by `enable_compilation_cache`, or None for each
    library's own default."""
    return _CACHE_DIR


def enable_compilation_cache(cache_dir: Optional[str]) -> None:
    """Build and load the kernel libraries in `cache_dir` (no-op if None)."""
    global _CACHE_DIR
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    _CACHE_DIR = Path(cache_dir).resolve()


def enable_default_compilation_cache() -> str:
    """Enable the cache at `RRTPU_COMPILE_CACHE`, else at the kernels'
    repo-local build directory (`ops/kernels/_build/`), and return it."""
    from reflecting_reality_tpu_torch.ops.kernels.build import DEFAULT_BUILD_DIR

    cache_dir = os.environ.get("RRTPU_COMPILE_CACHE") or str(DEFAULT_BUILD_DIR)
    enable_compilation_cache(cache_dir)
    return cache_dir
