"""Fine-tuning: the program's training step (`training/train_step.py`'s
`make_train_step`, the recipe of `launchers/train.sh`) fed by its loader
(`data/loader.py`'s `DataLoader` and `prefetch_to_device`) from a latent
cache that set-up writes from the seed, as the card runs of `cli/train.py`
do.

Set-up builds the one training state, drives it through its first steps on
the window's own feed (the reference follows those), and hands it to the
window.  End to end: `train_samples_per_s`, the samples of every step the
window ran over the window's length, which ends in a synchronise.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from bench_h100 import harness, traffic
from bench_h100.trace import ThreadProfiler

MIRROR_PROMPT = "A perfect plane mirror reflection of "


def write_cache(root: str, n: int, hl: int, seed: int) -> list:
    """n samples in the precompute tool's .npz layout from the seed -> the
    dataset's rows."""
    from reflecting_reality_tpu_torch.data.latent_cache import cache_name

    rows = []
    for i in range(n):
        rng = traffic.rng_for(seed, 10, i)

        def moments():
            return np.concatenate([rng.standard_normal((hl, hl, 4)),
                                   rng.uniform(-6.0, -2.0, (hl, hl, 4))], -1).astype(np.float16)

        row = {"uid": f"s{i}", "path": f"obj/{i}.hdf5",
               "auto_caption": " ".join(traffic.WORDS[j] for j in
                                        rng.choice(len(traffic.WORDS), int(rng.integers(3, 30))))}
        mask = np.zeros((hl, hl, 1), np.float32)
        t, l, h, w = (int(v) for v in rng.integers([0, 0, hl // 8, hl // 8],
                                                   [hl // 2, hl // 2, hl // 2, hl // 2]))
        mask[t:t + h, l:l + w] = 1.0
        np.savez(os.path.join(root, cache_name(row, i)), latent_moments=moments(),
                 cond_latent_moments=moments(), masks=mask,
                 depths=rng.uniform(-1.0, 1.0, (hl, hl, 1)).astype(np.float32))
        rows.append(row)
    return rows


def reference_batch(root: str, rows: list, idxs, params: dict, seed: int, vocab: int, device):
    """A batch as the loader builds it, worked out again: the cached arrays
    and the captions with the recipe's empty-prompt dropout, item by item
    from (seed, epoch 0, index)."""
    import torch

    from bench_h100.reference.sampling import hash_tokens
    from reflecting_reality_tpu_torch.data.latent_cache import cache_name

    arrays, texts = {}, []
    for i in idxs:
        with np.load(os.path.join(root, cache_name(rows[i], i))) as z:
            for k in z.files:
                arrays.setdefault(k, []).append(z[k].astype(np.float32))
        drop = np.random.default_rng(np.random.SeedSequence([seed, 0, int(i)])).random()
        texts.append("" if drop < params["proportion_empty_prompts"]
                     else MIRROR_PROMPT + rows[i]["auto_caption"])
    batch = {k: torch.from_numpy(np.stack(v)).to(device) for k, v in arrays.items()}
    batch["input_ids"] = torch.from_numpy(hash_tokens(texts, vocab)).to(device)
    return batch


def run(run) -> None:
    import torch

    from reflecting_reality_tpu_torch.data.latent_cache import LatentCachedDataset
    from reflecting_reality_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig, make_train_step

    p, cfg = run.cell["params"], run.cfg
    on_card = run.device.type == "cuda"
    dtype = getattr(torch, cfg["dtype"])
    hl = int(p["resolution"]) // 8
    seed = run.seed % 2 ** 31           # numpy's RandomState takes 32 bits
    if on_card:
        harness.build_kernels()
    run.mark("kernels")
    # trainable modules keep fp32 masters; the frozen ones are stored in the
    # compute dtype, as cli/train.py stores them
    mods = harness.program_modules(cfg, run.seed, run.device, torch.float32,
                                   kinds=("unet", "brushnet"))
    mods.update(harness.program_modules(cfg, run.seed, run.device, dtype,
                                        kinds=("vae", "text_encoder")))
    root = tempfile.mkdtemp(prefix="bench_h100_cache_")
    try:
        rows = write_cache(root, int(p["samples"]), hl, run.seed)
        vocab = cfg["text_encoder"]["vocab_size"]
        dataset = LatentCachedDataset(root, rows, HashTokenizer(vocab_size=vocab),
                                      proportion_empty_prompts=p["proportion_empty_prompts"],
                                      mirror_prompt=MIRROR_PROMPT, seed=seed)
        loader = DataLoader(dataset, int(p["batch_size"]), shuffle=True,
                            num_workers=int(p["loader_workers"]), seed=seed)
        config = TrainConfig(learning_rate=p["learning_rate"], lr_scheduler="constant",
                             lr_warmup_steps=0, train_base_unet=True,
                             depth_conditioning_mode="concat", max_train_steps=10 ** 9,
                             scaling_factor=cfg["scaling_factor"])
        step_fn, init_state = make_train_step(mods["unet"], mods["brushnet"], mods["vae"],
                                              mods["text_encoder"], config, dtype=dtype,
                                              device=run.device)
        state = init_state()
        run.mark("weights")
        # the optimizer's leaf order: BrushNet's, then the UNet's
        names = [f"{k}.{n}" for k in ("brushnet", "unet") for n, _ in mods[k].named_parameters()]
        generator = torch.Generator(run.device).manual_seed(seed)

        def epochs():
            while True:
                yield from loader

        stream = prefetch_to_device(epochs(), run.device,
                                    transport_dtype=dtype if dtype != torch.float32 else None)
        try:
            first = first_steps(run, state, step_fn, stream, generator, int(p["checked_steps"]))
            run.mark("warm-up")
            window(run, state, step_fn, stream, generator, p)
        finally:
            stream.close()
        if on_card:
            run.device_extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
        del state, step_fn, init_state, mods
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        order = np.arange(len(rows))
        np.random.RandomState(seed).shuffle(order)
        b = int(p["batch_size"])
        batches = [order[k * b:(k + 1) * b] for k in range(int(p["checked_steps"]))]
        check(run, first, names, [reference_batch(root, rows, ix, p, seed, vocab, run.device)
                                  for ix in batches], seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def first_steps(run, state, step_fn, stream, generator, n: int) -> dict:
    """The set-up's steps on the window's feed: each step's loss, the first
    step's clipped gradient by leaf (AdamW's first moment after one step,
    over 1 - beta1), and each leaf's change after step n."""
    import torch

    params = state.params
    start = [q.detach().clone() for q in params]
    losses, grad_norms = [], None
    for k in range(n):
        state, m = step_fn(state, next(stream), generator)
        losses.append(float(m["loss"]))
        if k == 0:
            opt = state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            # a leaf the optimizer never updated has no moment: it got no gradient
            grad_norms = [float(opt.state[q]["exp_avg"].double().norm()) / (1 - beta1)
                          if "exp_avg" in opt.state.get(q, {}) else 0.0 for q in params]
    changes = [float((q.detach().double() - s.double()).norm()) for q, s in zip(params, start)]
    del start
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes}


def window(run, state, step_fn, stream, generator, p: dict) -> None:
    import torch

    from bench_h100.instrument import AttentionRanges

    profiler = ranges = None
    t0 = time.perf_counter()
    run.data["setup_s"] = t0 - run.t_start
    if run.trace:
        start = t0 + float(p["trace_offset_s"])
        profiler = ThreadProfiler(start, start + 60.0, max_ticks=int(p["trace_steps"]))
        ranges = AttentionRanges(lambda: profiler.active)
    steps, wait = 0, 0.0
    try:
        while True:
            if profiler is not None:
                profiler.tick()
            tw = time.perf_counter()
            batch = next(stream)
            wait += time.perf_counter() - tw
            state, _ = step_fn(state, batch, generator)
            steps += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        if ranges is not None:
            ranges.remove()
    if profiler is not None:
        profiler.stop()
        run.trace_obj = profiler.read()
    b = int(p["batch_size"])
    run.attempted = steps
    run.e2e = {"train_samples_per_s": steps * b / (t1 - t0), "setup_s": run.data["setup_s"]}
    run.data.update(window_s=t1 - t0, samples=steps * b, loader_wait_s=wait,
                    attention_calls=ranges.calls if ranges else {})


def check(run, first: dict, names, batches, seed: int) -> None:
    """The set-up's first steps against the reference's on the same batches
    and draws."""
    import torch

    from bench_h100.reference import training

    p = run.cell["params"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = harness.reference_modules(run.cfg, run.seed, run.device, torch.float32,
                                        kinds=("unet", "brushnet", "text_encoder"))
        ref["text_encoder"].requires_grad_(False)
        named = {f"{k}.{n}": q for k in ("brushnet", "unet")
                 for n, q in ref[k].named_parameters()}
        params = [named[n] for n in names]          # the program's leaf order
        out = training.train_steps(ref, names, params, batches,
                                   torch.Generator(run.device).manual_seed(seed),
                                   run.cfg["scaling_factor"], p["learning_rate"], 1.0, 1e-2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    summarise(run, first, out)


def summarise(run, first: dict, ref: dict) -> None:
    """The cell's limits name the numbers compared: the first step's
    gradient by its worst leaf and the change after the checked steps by
    its median leaf.  The losses and the worst leaf's change are printed
    beside them: bf16 compute rounds most of a 1e-5 update of the weights
    away and fp32 does not, so the later steps part (PERF.md)."""
    from bench_h100.reference.training import readings

    limits = run.cell["limits"]
    r = readings(first, ref)
    print(f"reading losses program {first['losses']!r} reference {ref['losses']!r}; "
          f"first step's loss gap {r['loss1_rel']!r} (not compared: the control reads it "
          f"under three times the sound runs' largest); worst leaf's change gap "
          f"{r['change_worst_gap']!r}; {r['left_out']} leaves left out of the change "
          f"(reference gradient under 1e-3 of the median leaf's)", file=sys.stderr)
    for name in limits:
        run.check(name, r[name], limits[name])
