"""A real multi-process dry run of the port: two `torch.distributed` (gloo)
processes on the CPU at tiny width (counterpart of
`reflecting_reality_tpu/tools/multiprocess_dryrun.py`).

The reference's production path is multi-process by construction
(`accelerate launch --num_processes=8`; process-group init at
train_brushnet_mirror.py:902-907; the eval barrier and CSV merge at
metrics/evaluate_metrics.py:376-381).  Each worker runs, in a group of two:
  1. `parallel.multihost.initialize` (gloo, a TCP rendezvous on a port the
     launcher took from the OS) -> rank and world size;
  2. one data-parallel training step (`training.train_step`) on its half of
     a global batch of GLOBAL_BATCH; the launcher holds it against one
     process running the same step on the whole batch with the same seed:
     the loss and gradient norm at rtol 1e-5, the first AdamW moment
     (0.1 x the clipped gradient) at 1e-4 of its largest element, and the
     two ranks' parameters and moments bit-identical;
  3. `data.loader.DataLoader` striding: each rank's rows of every global
     batch are disjoint and together are the one-process batch, in order;
  4. `multihost.barrier` between the phases;
  5. the evaluation's CSV shards: `split_between_processes` over N_UIDS
     uids, one CSV a rank (`metrics.evaluate.save_dfs`), a barrier, and
     rank 0's `merge_csv_files` holding every cell.

`--inputs FILE` (a `torch.save` of {"state_dicts": {unet, brushnet, vae,
text}, "batch": the global batch, "draws": its draws, "config": TrainConfig
fields}) runs phase 2 from those weights, batch and random numbers instead
of the seeded ones, so a test can hold the two ranks against another
implementation's single-process step.

Usage:
    python -m reflecting_reality_tpu_torch.tools.multiprocess_dryrun [--out_dir D]
(the launcher; it starts the workers itself and gives each WORKER_TIMEOUT_S
seconds, so a hung rank fails the run, and kills every worker it started
before it returns).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

GLOBAL_BATCH = 4
N_UIDS = 7
PX = 16                               # pixels; latents 2x2
WORKER_TIMEOUT_S = 120.0
# the tiny config of the training tests: 2-block UNet and BrushNet, 4-level
# VAE, 1-layer CLIP
UNET_CFG = dict(down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), block_out_channels=(8, 16),
                attention_head_dim=2, cross_attention_dim=16, norm_num_groups=4,
                layers_per_block=1)
BRUSHNET_CFG = dict(UNET_CFG, down_block_types=("DownBlock2D", "DownBlock2D"),
                    mid_block_type="MidBlock2D", up_block_types=("UpBlock2D", "UpBlock2D"),
                    conditioning_channels=6)
VAE_CFG = dict(block_out_channels=(4, 4, 4, 4), norm_num_groups=2)
TEXT_CFG = dict(vocab_size=100, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32)
STEP_CFG = dict(learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=100,
                train_base_unet=True, snr_gamma=5.0)


# ---------------------------------------------------------------- worker ----

def tiny_modules(state_dicts: Optional[dict] = None) -> dict:
    """The four tiny modules, from `state_dicts` or from seed 0."""
    import torch

    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    torch.manual_seed(0)
    mods = dict(unet=UNet2DConditionModel(sample_size=2, **UNET_CFG),
                brushnet=BrushNetModel(**BRUSHNET_CFG), vae=AutoencoderKL(**VAE_CFG),
                text=CLIPTextModel(**TEXT_CFG))
    if state_dicts is not None:
        for k, m in mods.items():
            m.load_state_dict(state_dicts[k], strict=True)
    else:
        with torch.no_grad():   # zero convs start at zero: give them values
            for p in mods["brushnet"].parameters():
                if not p.abs().sum() > 0:
                    p.normal_(0.0, 0.1)
    return mods


def global_batch(n: int = GLOBAL_BATCH, seed: int = 0) -> dict:
    """The loader's NHWC dict of a global batch, as numpy."""
    import numpy as np

    r = np.random.RandomState(seed)
    return {
        "pixel_values": r.randn(n, PX, PX, 3).astype(np.float32),
        "conditioning_pixel_values": r.randn(n, PX, PX, 3).astype(np.float32),
        "masks": (r.rand(n, PX, PX, 1) > 0.5).astype(np.float32),
        "depths": r.randn(n, PX, PX, 1).astype(np.float32),
        "input_ids": r.randint(0, 100, (n, 7)).astype(np.int32),
    }


def _train_phase(args, rank: int, world: int) -> dict:
    """One data-parallel step on this rank's rows -> its loss, gradient
    norm, and (saved beside the result) its parameters and first moments."""
    import torch

    from reflecting_reality_tpu_torch.parallel import multihost
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig, make_train_step

    inputs = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    mods = tiny_modules(inputs.get("state_dicts"))
    config = TrainConfig(**inputs.get("config", STEP_CFG))
    step, init = make_train_step(mods["unet"], mods["brushnet"], mods["vae"], mods["text"],
                                 config, device="cpu")
    state = init()
    full = inputs.get("batch") or global_batch()
    b = len(full["input_ids"]) // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in full.items()}
    multihost.barrier("train-step-ready")
    state, m = step(state, local, torch.Generator().manual_seed(1), draws=inputs.get("draws"))
    multihost.barrier("after-train-step")
    named = {f"{k}.{n}": p for k, mod in state.trainable.items()
             for n, p in mod.named_parameters()}
    torch.save({"params": {n: p.detach() for n, p in named.items()},
                "exp_avg": {n: state.optimizer.state[p]["exp_avg"] for n, p in named.items()}},
               os.path.join(args.out_dir, f"state_{world}p_{rank}.pt"))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "nonfinite_skipped": float(m["nonfinite_skipped"])}


def run_worker(args) -> None:
    import numpy as np
    import torch

    from reflecting_reality_tpu_torch.parallel import multihost
    from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes

    torch.set_num_threads(1)
    if args.num_processes > 1:
        multihost.initialize(backend="gloo", device="cpu",
                             init_method=f"tcp://127.0.0.1:{args.port}",
                             rank=args.process_id, world_size=args.num_processes,
                             timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    rank, world = multihost.rank_and_world()
    assert (rank, world) == (args.process_id, args.num_processes), (rank, world)
    result = {"process_id": rank, "process_count": world, **_train_phase(args, rank, world)}

    # loader striding: the same shuffled order, each rank its rows
    from reflecting_reality_tpu_torch.data.loader import DataLoader

    class IndexDataset:
        def __len__(self):
            return 4 * GLOBAL_BATCH + 3           # the partial tail is dropped

        def __getitem__(self, i):
            return {"idx": np.array([i], np.int64)}

    loader = DataLoader(IndexDataset(), batch_size=GLOBAL_BATCH, shuffle=True, num_workers=2,
                        seed=7, process_index=rank, process_count=world)
    result["local_indices"] = [b["idx"][:, 0].tolist() for b in loader]
    multihost.barrier("after-loader")

    # the evaluation's CSV shards, merged by rank 0
    import pandas as pd

    from reflecting_reality_tpu_torch.metrics import evaluate as ev

    uids = [f"uid{i:02d}" for i in range(N_UIDS)]
    ev_args = argparse.Namespace(infer_dir=args.out_dir, output_csv=f"eval{world}p",
                                 num_images_per_validation=1)
    df = pd.DataFrame({c: [float("nan")] * len(uids) for c in ev.columns})
    df["uid"] = uids
    for uid in split_between_processes(uids):
        df.at[uids.index(uid), "PSNR"] = 10.0 + uids.index(uid)   # a stand-in metric cell
    ev.save_dfs(ev_args, [df], shard_id=rank)
    multihost.barrier("eval-shards-written")
    result["merged_ok"] = None
    if multihost.is_main_process():
        ev.merge_csv_files(ev_args, delete_intermediate=True)
        out = pd.read_csv(os.path.join(args.out_dir, f"eval{world}p_0.csv"))
        result["merged_ok"] = bool(
            len(out) == N_UIDS and not out["PSNR"].isna().any()
            and np.allclose(sorted(out["PSNR"]), [10.0 + i for i in range(N_UIDS)]))
    multihost.barrier("eval-merged")
    with open(os.path.join(args.out_dir, f"result_{world}p_{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"worker {rank}/{world}: ok loss={result['loss']:.6f}", flush=True)


# -------------------------------------------------------------- launcher ----

def free_port() -> int:
    """A TCP port the OS has free on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(commands: List[List[str]], logs: List[str], timeout_s: float = WORKER_TIMEOUT_S,
          env: Optional[dict] = None, cwd: Optional[str] = None) -> None:
    """Run the commands as processes side by side, each logging to its file;
    raise with a log's tail if one fails or any outlives `timeout_s`.  Every
    process is gone when this returns or raises."""
    env = dict(os.environ if env is None else env, PYTHONUNBUFFERED="1")
    procs = []
    try:
        for cmd, log in zip(commands, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                              cwd=cwd))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers still running after {timeout_s:.0f} s: "
                                   + _tails(procs, logs))
            if any(p.returncode not in (None, 0) for p in procs):
                break                   # one failed: the others would wait for it
            time.sleep(0.05)
        if any(p.returncode != 0 for p in procs if p.poll() is not None):
            raise RuntimeError("a worker failed: " + _tails(procs, logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _tails(procs, logs) -> str:
    out = []
    for i, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            out.append(f"\n--- worker {i} (rc={p.poll()}) ---\n{f.read()[-3000:]}")
    return "".join(out)


def _worker_cmd(args, n: int, rank: int, port: int) -> List[str]:
    cmd = [sys.executable, "-m", "reflecting_reality_tpu_torch.tools.multiprocess_dryrun",
           "--worker", "--process_id", str(rank), "--num_processes", str(n), "--port", str(port),
           "--out_dir", args.out_dir]
    return cmd + (["--inputs", args.inputs] if args.inputs else [])


def run_workers(args, n: int) -> List[dict]:
    """Start `n` workers (a group of n when n > 1) and read their results."""
    port = free_port()
    spawn([_worker_cmd(args, n, r, port) for r in range(n)],
          [os.path.join(args.out_dir, f"worker_{n}p_{r}.log") for r in range(n)],
          cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    results = []
    for r in range(n):
        with open(os.path.join(args.out_dir, f"result_{n}p_{r}.json")) as f:
            results.append(json.load(f))
    return results


def check(out_dir: str, two: List[dict], one: dict) -> dict:
    """The launcher's cross-process checks -> the summary (raises on a
    failed one)."""
    import torch

    assert [r["process_count"] for r in two] == [2, 2], two
    assert two[0]["loss"] == two[1]["loss"], "the averaged loss differs between the ranks"
    for key in ("loss", "grad_norm"):
        a, b = two[0][key], one[key]
        assert abs(a - b) <= 1e-5 * abs(b), f"2-process {key} {a} != 1-process {b}"
    s0, s1, ref = (torch.load(os.path.join(out_dir, f), weights_only=True)
                   for f in ("state_2p_0.pt", "state_2p_1.pt", "state_1p_0.pt"))
    for part in ("params", "exp_avg"):
        for name in s0[part]:
            assert torch.equal(s0[part][name], s1[part][name]), f"{part} {name} differs by rank"
    tol = 1e-4 * max(v.abs().max().item() for v in ref["exp_avg"].values())
    moment_err = max((s0["exp_avg"][n] - ref["exp_avg"][n]).abs().max().item()
                     for n in ref["exp_avg"])
    assert moment_err <= tol, f"first moment off by {moment_err} (tolerance {tol})"
    for b0, b1, bref in zip(two[0]["local_indices"], two[1]["local_indices"],
                            one["local_indices"]):
        assert not set(b0) & set(b1), "the ranks' rows overlap"
        assert b0 + b1 == bref, "the ranks' rows do not make the global batch"
    assert len(one["local_indices"]) == 4 and two[0]["merged_ok"] is True
    return {"ok": True, "process_count": 2, "loss_2proc": two[0]["loss"],
            "loss_1proc": one["loss"], "grad_norm_2proc": two[0]["grad_norm"],
            "grad_norm_1proc": one["grad_norm"], "first_moment_max_err": moment_err,
            "first_moment_tol": tol, "n_batches_checked": len(one["local_indices"]),
            "merged_ok": True, "out_dir": out_dir}


def run_launcher(args) -> dict:
    args.out_dir = args.out_dir or tempfile.mkdtemp(prefix="rr_torch_mpdryrun_")
    os.makedirs(args.out_dir, exist_ok=True)
    two = run_workers(args, 2)
    one = run_workers(args, 1)[0]
    summary = check(args.out_dir, two, one)
    print("multiprocess_dryrun:", json.dumps(summary), flush=True)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--inputs", default=None,
                    help="torch.save file of the step's weights, global batch and draws")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.worker:
        run_worker(args)
        return None
    return run_launcher(args)


if __name__ == "__main__":
    main()
