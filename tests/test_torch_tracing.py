"""The port's spans (`reflecting_reality_tpu_torch/core/tracing.py`) on tiny
CPU modules: nothing recorded and no profiler range opened while tracing is
off, and only the ranges under a profiler; the span tree of a 3-step pipeline call; the batched server's batch
and queue-wait spans; the training step's parts and the loader's wait; and
the `#id` pairing of records with a CPU profiler trace's ranges, whose
median offset maps the host clock onto the trace's."""

import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from reflecting_reality_tpu_torch.cli.serve import BatchingPipelineServer
from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.data.loader import prefetch_to_device
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from reflecting_reality_tpu_torch.training.train_step import TrainConfig, make_train_step
from tests.test_torch_helpers import TINY, TINY_TEXT, TINY_VAE
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

PX = 64
STEPS = 3
TIMEOUT = 120


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    return StableDiffusionBrushNetPipeline(
        vae=AutoencoderKL(**TINY_VAE), text_encoder=CLIPTextModel(**TINY_TEXT),
        tokenizer=HashTokenizer(vocab_size=1000),
        unet=UNet2DConditionModel(sample_size=8, **TINY),
        brushnet=BrushNetModel(conditioning_channels=6, **TINY),
        depth_conditioning_mode="concat", device="cpu")


def call(pipe, prompt="a mirror", seed=0):
    z = np.zeros((1, PX, PX, 3), np.float32)
    return pipe(prompt=[prompt], image=z, mask=np.ones_like(z), depth=z[..., :1],
                num_inference_steps=STEPS, seed=seed)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_opens_no_range(pipe, monkeypatch):
    assert not tracing.enabled()
    assert tracing.span("rr.x") is tracing.span("rr.y", i=1)   # one shared no-op

    def no_range(*args, **kwargs):
        raise AssertionError("a profiler range opened with tracing off and no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    call(pipe)
    assert tracing.take() == {"spans": []}


def test_off_under_a_profiler_opens_ranges_and_records_nothing(pipe):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(pipe)
    names = [e.name for e in prof.events() if e.name.startswith("rr.")]
    assert {n.split("#")[0] for n in names} >= {"rr.pipeline.call", "rr.pipeline.step",
                                               "rr.brushnet", "rr.unet"}
    assert all(n.split("#")[1].isdigit() for n in names)
    assert sum(n.startswith("rr.pipeline.step#") for n in names) == STEPS
    assert tracing.take() == {"spans": []}
    assert tracing.span("rr.x") is tracing.span("rr.y")        # the profiler gone: no-op again


def test_span_tree_of_a_pipeline_call(pipe):
    tracing.enable()
    call(pipe)
    spans = tracing.take()["spans"]
    assert tracing.take() == {"spans": []}                     # take() empties the store
    named = by_name(spans)
    (top,) = named["rr.pipeline.call"]
    assert top["parent"] is None
    assert top["attrs"] == {"batch_size": 1, "steps": STEPS, "height": PX}
    for name in ("rr.pipeline.text", "rr.pipeline.conditioning", "rr.pipeline.denoise",
                 "rr.pipeline.decode", "rr.pipeline.output"):
        (s,) = named[name]
        assert s["parent"] == top["id"], name
        assert top["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= top["t1_ns"]
    order = sorted(["rr.pipeline.text", "rr.pipeline.conditioning", "rr.pipeline.denoise",
                    "rr.pipeline.decode", "rr.pipeline.output"],
                   key=lambda n: named[n][0]["t0_ns"])
    assert order == ["rr.pipeline.text", "rr.pipeline.conditioning", "rr.pipeline.denoise",
                     "rr.pipeline.decode", "rr.pipeline.output"]
    (denoise,) = named["rr.pipeline.denoise"]
    steps = named["rr.pipeline.step"]
    assert [s["attrs"]["i"] for s in steps] == list(range(STEPS))
    assert all(s["parent"] == denoise["id"] for s in steps)
    for step in steps:
        kids = [s for s in spans if s["parent"] == step["id"]]
        assert [k["name"] for k in sorted(kids, key=lambda k: k["t0_ns"])] == [
            "rr.brushnet", "rr.unet", "rr.pipeline.scheduler"]
        assert all(k["attrs"]["i"] == step["attrs"]["i"] for k in kids)
    assert {s["attrs"]["mode"] for s in named["rr.unet"]} == {"full"}
    assert len({s["id"] for s in spans}) == len(spans)
    assert {s["tid"] for s in spans} == {threading.get_native_id()}


def test_batched_server_spans_one_batch_and_each_queue_wait(pipe):
    server = BatchingPipelineServer(pipe, default_steps=STEPS, max_batch=2,
                                    batch_window_s=TIMEOUT)
    z = np.zeros((PX, PX, 3), np.float32)
    payload = {"image": z, "mask": np.ones_like(z), "depth": z[..., :1]}
    replies, errors = [None, None], []

    def send(k):
        try:
            replies[k] = server.generate(dict(payload, prompt=f"mirror {k}", seed=k))
        except Exception as e:                # reported below
            errors.append(e)

    tracing.enable()
    try:
        threads = [threading.Thread(target=send, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        server.close()
    assert [r["batch_size"] for r in replies] == [2, 2]
    spans = tracing.take()["spans"]
    named = by_name(spans)
    (batch,) = named["rr.serve.batch"]
    requests = named["rr.serve.request"]
    ids = sorted(r["attrs"]["request"] for r in requests)
    assert sorted(batch["attrs"]["requests"]) == ids and batch["attrs"]["size"] == 2
    assert all(r["attrs"]["batch"] == batch["attrs"]["batch"] for r in requests)
    waits = named["rr.serve.queue_wait"]
    assert sorted(w["attrs"]["request"] for w in waits) == ids
    for w in waits:
        (req,) = [r for r in requests if r["attrs"]["request"] == w["attrs"]["request"]]
        assert w["parent"] == req["id"] and w["attrs"]["batch"] == batch["attrs"]["batch"]
        assert req["t0_ns"] <= w["t0_ns"] <= w["t1_ns"] == batch["t0_ns"]
    for enc in named["rr.serve.encode"]:
        (req,) = [r for r in requests if r["id"] == enc["parent"]]
        assert enc["attrs"]["request"] == req["attrs"]["request"]
        assert batch["t1_ns"] <= enc["t0_ns"] <= enc["t1_ns"] <= req["t1_ns"]
    (call_span,) = named["rr.pipeline.call"]
    assert call_span["parent"] == batch["id"] and call_span["tid"] == batch["tid"]
    assert all(r["tid"] != batch["tid"] for r in requests)    # handler threads, not the worker


CFG = dict(down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
           up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), block_out_channels=(8, 16),
           attention_head_dim=2, cross_attention_dim=16, norm_num_groups=4, layers_per_block=1)
BCFG = dict(CFG, down_block_types=("DownBlock2D", "DownBlock2D"), mid_block_type="MidBlock2D",
            up_block_types=("UpBlock2D", "UpBlock2D"))


def test_train_step_spans_and_loader_wait():
    torch.manual_seed(0)
    step_fn, init = make_train_step(
        UNet2DConditionModel(sample_size=2, **CFG), BrushNetModel(conditioning_channels=6, **BCFG),
        AutoencoderKL(block_out_channels=(4, 4, 4, 4), norm_num_groups=2),
        CLIPTextModel(vocab_size=100, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32),
        TrainConfig(learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=10), device="cpu")
    state = init()
    r = np.random.RandomState(0)
    batch = {"pixel_values": r.randn(2, 16, 16, 3).astype(np.float32),
             "conditioning_pixel_values": r.randn(2, 16, 16, 3).astype(np.float32),
             "masks": (r.rand(2, 16, 16, 1) > 0.5).astype(np.float32),
             "depths": r.randn(2, 16, 16, 1).astype(np.float32),
             "input_ids": r.randint(0, 100, (2, 7)).astype(np.int32)}
    tracing.enable()
    stream = prefetch_to_device(iter([batch]), "cpu")
    try:
        state, _ = step_fn(state, next(stream), torch.Generator().manual_seed(0))
    finally:
        stream.close()
    spans = tracing.take()["spans"]
    named = by_name(spans)
    (step,) = named["rr.train.step"]
    assert step["attrs"] == {"step": 0} and step["parent"] is None
    kids = sorted((s for s in spans if s["parent"] == step["id"]), key=lambda s: s["t0_ns"])
    assert [k["name"] for k in kids] == ["rr.train.forward", "rr.train.backward",
                                         "rr.train.all_reduce", "rr.train.host_read",
                                         "rr.train.optimizer"]
    reads = named["rr.train.host_read"]
    (opt,) = named["rr.train.optimizer"]
    assert len(reads) == 2
    assert {r["attrs"]["what"]: r["parent"] for r in reads} == {"finite": step["id"],
                                                                "grad_norm": opt["id"]}
    waits = named["rr.loader.wait"]
    assert waits and all(w["parent"] is None for w in waits)
    assert waits[0]["t1_ns"] <= step["t0_ns"]


def test_id_pairing_and_clock_offset_on_a_cpu_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with tracing.span("rr.outer", k=k):
                with tracing.span("rr.inner"):
                    torch.ones(64).add_(1)
                time.sleep(0.002)
    tracing.record("rr.memory_only", time.perf_counter_ns() - 1000, time.perf_counter_ns())
    spans = tracing.take()["spans"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = {e["name"]: e for e in events
              if e.get("ph") == "X" and e.get("name", "").startswith("rr.")}
    paired = [(s, ranges[f"{s['name']}#{s['id']}"]) for s in spans
              if f"{s['name']}#{s['id']}" in ranges]
    assert len(paired) == 10 == len(ranges)           # every span's range; none for `record`
    assert not [n for n in ranges if n.startswith("rr.memory_only")]
    offset = statistics.median(r["ts"] - s["t0_ns"] / 1e3 for s, r in paired)
    for s, r in paired:
        assert abs(r["ts"] - (s["t0_ns"] / 1e3 + offset)) < 1000.0         # within 1 ms
        assert abs(r["ts"] + r["dur"] - (s["t1_ns"] / 1e3 + offset)) < 1000.0


def test_the_store_keeps_the_last_records():
    tracing.enable()
    for k in range(tracing.MAX_RECORDS + 5):
        tracing.record("rr.x", k, k + 1)
    spans = tracing.take()["spans"]
    assert len(spans) == tracing.MAX_RECORDS
    assert spans[0]["t0_ns"] == 5 and spans[-1]["t0_ns"] == tracing.MAX_RECORDS + 4
    assert tracing.take() == {"spans": []}
