"""The controls that set the upper readings of a cell's limits, run on the
card at the cell's own size (never by the benchmark's own runs):

    python3 -m bench_h100.control --workload sd15-serve-poisson --seeds A,B,C
    python3 -m bench_h100.control --workload sd15-train-bs4 --seeds A,B,C

Serving and SDXL: the cell itself for a short window at its own load,
with the program's own lower-precision path switched on (W8A8 int8,
`enable_int8()`) and, beside it, exact; each run's check compares as many
images as a benchmark run does.  Training: the reference computed with
float8 e4m3 inputs to every product (the step below bf16) in the program's
place, and the reference with half of each batch (the mean over the rest),
each against the fp32 reference on the same batches and draws.  Each seed
prints one JSON line of readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np

from bench_h100 import harness


def image_readings(cell: dict, seed: int, seconds: float) -> dict:
    """The cell run in this process for a short window at its own load,
    exact and then with the program's int8 path switched on -> each run's
    compared numbers."""
    import contextlib
    import io

    import torch

    from bench_h100 import run as entry

    out = {"seed": seed}
    for mode in (None, "int8"):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = entry.main(["--workload", cell["name"], "--seed", str(seed), "--seconds",
                             repr(seconds), "--trace", "0"], control=mode)
        if rc != 0:
            raise RuntimeError(f"the run exited {rc}: {err.getvalue()[-3000:]}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        # every image's gaps from the check's reading lines, the worst of each
        gaps = [json.loads(t[t.index("{"):t.index("}") + 1])
                for t in err.getvalue().splitlines() if t.startswith("reading ")]
        out[mode or "exact"] = dict({k: v["value"] for k, v in line["checks"].items()},
                                    worst={k: max(g[k] for g in gaps) for k in gaps[0]})
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_readings(cfg: dict, cell: dict, seed: int, device) -> dict:
    import shutil
    import tempfile

    import torch

    from bench_h100.drivers import train_loop
    from bench_h100.reference import models, training

    p = cell["params"]
    s = seed % 2 ** 31
    root = tempfile.mkdtemp(prefix="bench_h100_control_")
    results = {}
    try:
        rows = train_loop.write_cache(root, int(p["samples"]), int(p["resolution"]) // 8, seed)
        order = np.arange(len(rows))
        np.random.RandomState(s).shuffle(order)
        # data parallel: the reference follows the global batch
        b = int(p["batch_size"]) * (int(cell["chips"]) if cell["kind"] == "train_ddp" else 1)
        vocab = cfg["text_encoder"]["vocab_size"]
        batches = [train_loop.reference_batch(root, rows, order[k * b:(k + 1) * b], p, s, vocab,
                                              device) for k in range(int(p["checked_steps"]))]
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            for mode in ("fp32", "fp8", "half_batch"):
                models.QUANT = "fp8" if mode == "fp8" else None
                ref = harness.reference_modules(cfg, seed, device, torch.float32,
                                                kinds=("unet", "brushnet", "text_encoder"))
                ref["text_encoder"].requires_grad_(False)
                names = [f"{k}.{n}" for k in ("brushnet", "unet")
                         for n, _ in ref[k].named_parameters()]
                params = [q for k in ("brushnet", "unet") for q in ref[k].parameters()]
                feed = batches
                if mode == "half_batch":      # the mean over half of each batch
                    feed = [dict(x, **{k: v[: b // 2] for k, v in x.items()}) for x in batches]
                gen = torch.Generator(device).manual_seed(s)
                if mode == "half_batch":
                    results[mode] = _half(ref, names, params, feed, gen, cfg, p, b, device)
                else:
                    results[mode] = training.train_steps(
                        ref, names, params, feed, gen, cfg["scaling_factor"],
                        p["learning_rate"], 1.0, 1e-2)
                del ref, params
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            models.QUANT = None
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"seed": seed, "losses_fp32": results["fp32"]["losses"]}
    for mode in ("fp8", "half_batch"):
        out[mode] = dict(training.readings(results[mode], results["fp32"]),
                         losses=results[mode]["losses"])
    return out


def _half(ref, names, params, feed, gen, cfg, p, b, device):
    """The reference's step on the first half of each batch, with the whole
    batch's draws (a step that leaves half the batch out)."""
    import torch

    from bench_h100.reference import training

    real = training.step_draws

    def draws(g, n, hl, wl, dev):
        full = real(g, b, hl, wl, dev)
        return {k: v[:n] for k, v in full.items()}

    training.step_draws = draws
    try:
        return training.train_steps(ref, names, params, feed, gen, cfg["scaling_factor"],
                                    p["learning_rate"], 1.0, 1e-2)
    finally:
        training.step_draws = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="the image cells' short window at the cell's own load")
    args = ap.parse_args(argv)
    harness.use_caches()
    import torch

    cell = harness.load_cell(args.workload)
    cfg = harness.load_config(cell["config"])
    device = torch.device("cuda", 0)
    harness.build_kernels()
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["kind"] in ("train_loop", "train_ddp"):
            res = train_readings(cfg, cell, seed, device)
        else:
            res = image_readings(cell, seed, args.seconds)
        print(json.dumps(dict(res, gpu=torch.cuda.get_device_name(0))), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
