"""What every cell shares: finding a cell, its configuration and its
per-layer metrics by name; the caches; the program's modules at a
configuration's widths from the seed; the check that nothing of JAX was
loaded; the result line.

A cell is `workloads/<cell>.json` (its configuration, its driver kind, the
traffic parameters and its why); a configuration is `configs/<config>.json`;
a per-layer metric is `metrics/<metric>.py`, whose `read(ctx)` returns a
number or None.  `BENCHMARK.json` at the checkout's root says which
per-layer metrics a cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "reflecting_reality_tpu")
CACHE = HERE / "_cache"

PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cells() -> List[str]:
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def load_cell(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {name!r}; have {cells()}")
    cell = load_json(path)
    cell["name"] = name
    return cell


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def end_to_end_names(cell: str, bench: dict) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_names(cell: str, bench: dict) -> List[str]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(cell, bench))
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def metric_reader(name: str):
    """metrics/<name>.py's `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_h100.metrics." + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"bench_h100.drivers.{kind}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN and sys.modules.get(m) is not None})


def use_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout; JAX kept out of libraries that would load it themselves."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def build_kernels() -> None:
    """The program's kernel libraries built (first run of a checkout) or
    loaded, in parallel, into the benchmark's cache directory."""
    from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache
    from reflecting_reality_tpu_torch.ops.kernels import build

    enable_compilation_cache(str(CACHE / "kernels"))
    errors = []

    def one(name):
        try:
            build.load(name)
        except BaseException as e:           # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,))
               for n in ("flash_attn_fwd", "flash_attn_bwd", "groupnorm")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def program_modules(cfg: dict, seed: int, device, dtype, kinds=None) -> Dict[str, object]:
    """The program's modules at the configuration's widths, built on the
    meta device and filled from the seed on `device` in `dtype`."""
    import torch

    from bench_h100.weights import fill
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import (
        CLIPTextModel, CLIPTextModelWithProjection,
    )
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    classes = {"unet": UNet2DConditionModel, "brushnet": BrushNetModel,
               "vae": AutoencoderKL, "text_encoder": CLIPTextModel,
               "text_encoder_2": CLIPTextModelWithProjection}
    out = {}
    for kind in kinds or [k for k in classes if k in cfg]:
        with torch.device("meta"):
            module = classes[kind](**cfg[kind])
        fill(kind, module, seed, device, dtype)
        out[kind] = module
    return out


def reference_modules(cfg: dict, seed: int, device, dtype, kinds=None) -> Dict[str, object]:
    """The reference's modules with the same seeded values."""
    import torch

    from bench_h100.reference.models import build
    from bench_h100.weights import KINDS, fill

    out = {}
    for kind in kinds or [k for k in KINDS if k in cfg]:
        with torch.device("meta"):
            module = build(kind, cfg[kind])
        fill(kind, module, seed, device, dtype)
        out[kind] = module.eval()
    return out


def device_info(torch, count: int = 1) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple], device: dict,
         checks: List[dict], breakdown: Optional[dict] = None, extra_device: dict = None) -> None:
    """The compared numbers, each with its limit, as the last lines of
    standard error; then the one result line on standard output, the checks
    last in it."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
            "device": dict(device, **(extra_device or {}))}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
