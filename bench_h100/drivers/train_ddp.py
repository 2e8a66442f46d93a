"""Data-parallel fine-tuning: `train_loop`'s recipe in one process a card,
the ranks started here as torchrun would start them (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), NCCL between the cards, each rank
`batch_size` rows of a global batch of `batch_size` x ranks, the gradients
averaged by `parallel/multihost.py`'s bucketed `all_reduce_mean`.

The ranks run set-up, the checked first steps and the window; rank 0
decides each step whether the window goes on and broadcasts it, so every
rank runs the same steps.  Rank 0 writes its readings; the entry's process,
which holds no card while the ranks run, then checks the first steps
against the reference on the global batch and reports.  End to end:
`train_samples_per_s`, the samples of every rank over the window.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from bench_h100 import harness


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(run) -> None:
    world = run.chips
    out_dir = tempfile.mkdtemp(prefix="bench_h100_ddp_")
    port = free_port()
    spec = {"cell": run.cell, "cfg": run.cfg, "seed": run.seed, "seconds": run.seconds,
            "trace": run.trace, "t_start": run.t_start, "out": out_dir,
            "device": run.device.type}
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen([sys.executable, "-m", "bench_h100.drivers.train_ddp",
                                       spec_path], env=env, cwd=str(harness.ROOT)))
    try:
        deadline = time.monotonic() + 330.0
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"a rank failed: exit codes {[p.returncode for p in procs]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    run.attempted = r0["steps"]
    run.e2e = {"train_samples_per_s": r0["samples"] / r0["window_s"], "setup_s": r0["setup_s"]}
    run.data.update(window_s=r0["window_s"], samples=r0["samples"],
                    idle_shares=[r["idle_share"] for r in ranks if r.get("idle_share") is not None],
                    allreduce_device_s=r0.get("allreduce_device_s"),
                    traced_window_s=r0.get("traced_window_s"))
    run.trace_obj = _TraceSummary(r0) if r0.get("busy_s") is not None else None
    if run.device.type == "cuda":
        run.device_extra["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
        run.device_extra["count"] = world
    from bench_h100.drivers import train_loop

    p = run.cell["params"]
    seed = run.seed % 2 ** 31
    cache_rows, root = r0["rows"], r0["cache"]
    try:
        import numpy as np

        order = np.arange(len(cache_rows))
        np.random.RandomState(seed).shuffle(order)
        b = int(p["batch_size"]) * world
        if len(order) < b * int(p["checked_steps"]):
            raise ValueError("the checked steps must lie in the first epoch")
        batches = [train_loop.reference_batch(root, cache_rows, order[k * b:(k + 1) * b], p,
                                              seed, run.cfg["text_encoder"]["vocab_size"],
                                              run.device)
                   for k in range(int(p["checked_steps"]))]
        train_loop.check(run, r0["first"], r0["names"], batches, seed)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)


class _TraceSummary:
    """Rank 0's trace, read in its process: what the result line needs."""

    def __init__(self, r0: dict):
        self._busy, self.wall_s, self._breakdown = r0["busy_s"], r0["traced_window_s"], \
            r0["breakdown"]

    def busy_s(self) -> float:
        return self._busy

    def idle_share(self):
        return 1.0 - self._busy / self.wall_s if self._busy > 0 else None

    def breakdown(self) -> dict:
        return self._breakdown


def rank_main(spec_path: str) -> int:
    """One rank: set-up, the checked first steps, the window; rank 0 writes
    the readings the entry's process reports and checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bench_h100.drivers import train_loop
    from bench_h100.instrument import Ranges
    from bench_h100.trace import ThreadProfiler
    from reflecting_reality_tpu_torch.data.latent_cache import LatentCachedDataset
    from reflecting_reality_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.parallel import multihost
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig, make_train_step

    with open(spec_path) as f:
        spec = json.load(f)
    harness.use_caches()
    cell, cfg, p = spec["cell"], spec["cfg"], spec["cell"]["params"]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    on_card = spec["device"] == "cuda"
    multihost.initialize(backend="nccl" if on_card else "gloo",
                         device="cuda" if on_card else "cpu")
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        harness.build_kernels()
    dtype = getattr(torch, cfg["dtype"])
    seed = spec["seed"] % 2 ** 31
    mods = harness.program_modules(cfg, spec["seed"], device, torch.float32,
                                   kinds=("unet", "brushnet"))
    mods.update(harness.program_modules(cfg, spec["seed"], device, dtype,
                                        kinds=("vae", "text_encoder")))
    root = os.path.join(spec["out"], "cache")
    if rank == 0:
        os.makedirs(root)
        rows = train_loop.write_cache(root, int(p["samples"]), int(p["resolution"]) // 8,
                                      spec["seed"])
        with open(os.path.join(spec["out"], "rows.json"), "w") as f:
            json.dump(rows, f)
    multihost.barrier("cache")
    with open(os.path.join(spec["out"], "rows.json")) as f:
        rows = json.load(f)
    vocab = cfg["text_encoder"]["vocab_size"]
    dataset = LatentCachedDataset(root, rows, HashTokenizer(vocab_size=vocab),
                                  proportion_empty_prompts=p["proportion_empty_prompts"],
                                  mirror_prompt=train_loop.MIRROR_PROMPT, seed=seed)
    b = int(p["batch_size"])
    loader = DataLoader(dataset, b * world, shuffle=True, num_workers=int(p["loader_workers"]),
                        seed=seed, process_index=rank, process_count=world)
    config = TrainConfig(learning_rate=p["learning_rate"], lr_scheduler="constant",
                         lr_warmup_steps=0, train_base_unet=True,
                         depth_conditioning_mode="concat", max_train_steps=10 ** 9,
                         scaling_factor=cfg["scaling_factor"])
    step_fn, init_state = make_train_step(mods["unet"], mods["brushnet"], mods["vae"],
                                          mods["text_encoder"], config, dtype=dtype,
                                          device=device)
    state = init_state()
    names = [f"{k}.{n}" for k in ("brushnet", "unet") for n, _ in mods[k].named_parameters()]
    generator = torch.Generator(device).manual_seed(seed)

    def epochs():
        while True:
            yield from loader

    stream = prefetch_to_device(epochs(), device,
                                transport_dtype=dtype if dtype != torch.float32 else None)

    class Ctx:
        pass

    ctx = Ctx()
    ctx.device = device
    try:
        first = train_loop.first_steps(ctx, state, step_fn, stream, generator,
                                       int(p["checked_steps"]))
        go = torch.ones(1, device=device)
        profiler = ranges = None
        t0 = time.perf_counter()
        if spec["trace"]:
            start = t0 + float(p["trace_offset_s"])
            profiler = ThreadProfiler(start, start + 60.0, max_ticks=int(p["trace_steps"]))
            ranges = Ranges("reflecting_reality_tpu_torch.parallel.multihost", "all_reduce_mean",
                            "ar", lambda *a: (0.0, 0.0), lambda: profiler.active)
        steps = 0
        while True:
            if profiler is not None:
                profiler.tick()
            state, _ = step_fn(state, next(stream), generator)
            steps += 1
            if rank == 0:
                go.fill_(float(time.perf_counter() - t0 < spec["seconds"]))
            dist.broadcast(go, src=0)
            if not bool(go.item()):
                break
        if on_card:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        if ranges is not None:
            ranges.remove()
    finally:
        stream.close()
    res = {"rank": rank, "steps": steps, "samples": steps * b * world, "window_s": t1 - t0,
           "setup_s": t0 - spec["t_start"], "first": first, "names": names, "rows": rows,
           "cache": root,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}
    if profiler is not None:
        profiler.stop()
        tr = profiler.read()
        if tr is not None:
            res.update(idle_share=tr.idle_share(), busy_s=tr.busy_s(), traced_window_s=tr.wall_s,
                       breakdown=tr.breakdown(),
                       allreduce_device_s=sum(tr.range_device_s("bench.ar.").values()))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.barrier("done")
    dist.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1]))
