"""The port's HTTP serving layer (`reflecting_reality_tpu_torch/cli/serve.py`)
on a tiny CPU pipeline, mirroring tests/test_serve.py: healthz and generate
over a real socket, b64 PNG input, 400/404 replies, the payload decoding
held against the JAX package's on the same payloads, and the micro-batching
server (batched equals solo within 1 uint8 level, seeds per request, nip >
1, incompatible requests split, the batch window, a concurrent round trip,
a worker that survives a failing batch, 503 backpressure, the `dispatch`
payload), the normals ip_adapter payload, and `--attention_backend xla`
against the JAX server's pipeline.
Every HTTP call has a client timeout and every server stops in a `finally`."""

import base64
import io
import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from reflecting_reality_tpu.cli import serve as j_serve
from reflecting_reality_tpu_torch.cli import serve
from reflecting_reality_tpu_torch.cli.serve import (
    BatchingPipelineServer,
    OverloadedError,
    _Pending,
    _parse_payload,
    make_handler,
)
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.ip_adapter import DEFAULT_NUM_TOKENS, NormalProjModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_helpers import TINY, TINY_TEXT, TINY_VAE
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

H = W = 64
TIMEOUT = 60


def _tiny_pipe(ip: bool = False):
    """A tiny port pipeline from seeded torch weights (BrushNet's zero convs
    given signal), depth concat; with `ip` an ip UNet and a NormalProjModel."""
    torch.manual_seed(0)
    unet = UNet2DConditionModel(sample_size=8, ip_num_tokens=DEFAULT_NUM_TOKENS if ip else None,
                                **TINY)
    brushnet = BrushNetModel(conditioning_channels=6, **TINY)
    with torch.no_grad():
        for p in brushnet.parameters():
            if not p.abs().max() > 0:
                p.normal_(0.0, 0.05)
    return StableDiffusionBrushNetPipeline(
        vae=AutoencoderKL(**TINY_VAE), text_encoder=CLIPTextModel(**TINY_TEXT),
        tokenizer=HashTokenizer(vocab_size=1000), unet=unet, brushnet=brushnet,
        depth_conditioning_mode="concat",
        normals_conditioning_mode="ip_adapter" if ip else None,
        normal_proj=NormalProjModel(32) if ip else None, device="cpu")


@pytest.fixture(scope="module")
def tiny_pipe():
    return _tiny_pipe()


class _Http:
    """An HTTP server on 127.0.0.1 in a thread, stopped by `close`."""

    def __init__(self, server):
        self.server = server
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=TIMEOUT)
        self.server.close()


@pytest.fixture(scope="module")
def served(tiny_pipe):
    http = _Http(BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=1))
    try:
        yield http.url
    finally:
        http.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _payload(seed=0):
    rng = np.random.RandomState(7)
    mask = np.zeros((H, W, 3), np.float32)
    mask[16:48, 16:48] = 1.0
    return {"prompt": "a mirror", "image": rng.rand(H, W, 3).astype(np.float32).tolist(),
            "mask": mask.tolist(), "depth": rng.rand(H, W, 1).astype(np.float32).tolist(),
            "num_inference_steps": 2, "seed": seed}


def _distinct_payload(seed):
    rng = np.random.RandomState(100 + seed)
    mask = np.zeros((H, W, 3), np.float32)
    mask[16:48, 16:48] = 1.0
    return {"prompt": f"a mirror {seed}", "image": rng.rand(H, W, 3).astype(np.float32).tolist(),
            "mask": mask.tolist(), "depth": rng.rand(H, W, 1).astype(np.float32).tolist(),
            "num_inference_steps": 2, "seed": seed, "deterministic_vae_encode": True}


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _pixels(b64png):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64png)))).astype(np.int16)


def test_healthz(served):
    status, body = _get(served + "/healthz")
    assert status == 200 and body["status"] == "ok" and body["device"] == "cpu"


def test_generate_roundtrip(served):
    status, body = _post(served + "/generate", _payload())
    assert status == 200, body
    assert len(body["images"]) == 1 and body["latency_s"] > 0
    assert _pixels(body["images"][0]).shape == (H, W, 3)
    status2, body2 = _post(served + "/generate", _payload())
    assert status2 == 200 and body2["images"] == body["images"]      # same seed, same bytes


def test_generate_b64_png_input(served):
    rng = np.random.RandomState(7)
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 16:48] = 255
    payload = {"prompt": "a mirror", "image": _png_b64(rng.randint(0, 256, (H, W, 3), np.uint8)),
               "mask": _png_b64(mask), "depth": rng.rand(H, W, 1).astype(np.float32).tolist(),
               "num_inference_steps": 2}
    status, body = _post(served + "/generate", payload)
    assert status == 200, body


def test_missing_field_400_and_unknown_path_404(served):
    status, body = _post(served + "/generate", {"prompt": "x"})
    assert status == 400 and "missing field" in body["error"]
    status, body = _post(served + "/generate", [1, 2])
    assert status == 400 and "JSON object" in body["error"]
    status, _ = _post(served + "/nope", {})
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(served + "/nope")
    assert e.value.code == 404


def _image_payloads():
    rng = np.random.RandomState(3)
    a16 = np.linspace(0, 65535, 32 * 32).reshape(32, 32).astype(np.uint16)
    return [
        (_png_b64(a16), 1),                                                  # 16-bit PNG
        (_png_b64(np.full((8, 8), 255, np.uint8)), 1),                       # 8-bit grey
        (_png_b64(rng.randint(0, 256, (8, 8, 3), np.uint8)), 3),             # RGB
        (_png_b64(rng.randint(0, 256, (8, 8, 4), np.uint8)), 3),             # RGBA -> 3
        (_png_b64(rng.randint(0, 256, (8, 8), np.uint8)), 3),                # grey -> 3
        (np.linspace(-1, 1, 64).reshape(8, 8).astype(np.float32).tolist(), 1),  # floats
        (rng.rand(8, 8, 1).astype(np.float32).tolist(), 3),
    ]


@pytest.mark.parametrize("case", range(len(_image_payloads())))
def test_decode_image_matches_jax(case):
    value, channels = _image_payloads()[case]
    got = serve._decode_image(value, channels=channels)
    want = j_serve._decode_image(value, channels=channels)
    assert got.dtype == want.dtype == np.float32 and got.shape[-1] == channels
    np.testing.assert_array_equal(got, want)
    if case == 0:
        assert got.min() == 0.0 and abs(got.max() - 1.0) < 1e-4     # /65535, not /255


@pytest.mark.parametrize("mode", [None, "concat", "ip_adapter"])
def test_parse_payload_matches_jax(mode):
    # JAX reads the default dispatch from the pipeline, the port takes it
    pipe = types.SimpleNamespace(normals_conditioning_mode=mode, _serve_dispatch="per_step")
    payload = dict(_payload(3), guidance_scale=5, num_images_per_prompt=2,
                   negative_prompt="blurry", scheduler="ddim")
    if mode == "ip_adapter":
        payload["normals"] = [[0.0, 0.6, 0.8]]
    elif mode == "concat":
        payload["normals"] = _png_b64(np.random.RandomState(1).randint(0, 256, (H, W, 3),
                                                                       np.uint8))
    got = _parse_payload(payload, pipe, 7, "per_step")
    want = j_serve._parse_payload(payload, pipe, 7)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["dispatch"] == "per_step" and got["num_inference_steps"] == 2
    bare = {k: payload[k] for k in ("prompt", "image", "mask")}
    assert _parse_payload(bare, pipe, 7)["num_inference_steps"] == 7
    assert _parse_payload(bare, pipe, 7)["dispatch"] == "scan"
    with pytest.raises(ValueError, match="loop"):
        _parse_payload(dict(bare, dispatch="loop"), pipe, 7)


def _batched_server(pipe, **kw):
    srv = BatchingPipelineServer(pipe, default_steps=2, **kw)
    srv.close()          # no worker: the test drives _execute itself
    return srv


def test_batched_matches_solo(tiny_pipe):
    """Three distinct requests in one batched call equal their solo calls
    (deterministic VAE encode; per-request seeds as pre-drawn latents)."""
    srv = _batched_server(tiny_pipe, max_batch=4)
    payloads = [_distinct_payload(s) for s in (0, 3, 11)]
    reqs = [_Pending(_parse_payload(p, tiny_pipe, 2)) for p in payloads]
    srv._execute(reqs)
    assert srv.batches == 1 and srv.batched_requests == 3
    for p, r in zip(payloads, reqs):
        assert r.batch_size == 3 and len(r.images) == 1
        solo = tiny_pipe(**_parse_payload(p, tiny_pipe, 2))
        diff = np.abs(solo[0].astype(np.int16) - r.images[0].astype(np.int16))
        assert diff.max() <= 1, f"seed {p['seed']}: max uint8 diff {diff.max()}"
    assert not np.array_equal(reqs[0].images[0], reqs[1].images[0])


@pytest.mark.parametrize("nip", [1, 2])
def test_batch_of_one_is_the_solo_call(tiny_pipe, nip):
    """A request the worker runs alone gives its solo call's bytes, the
    stochastic VAE encode included (its draws follow the initial noise's in
    the request's own generator)."""
    srv = _batched_server(tiny_pipe, max_batch=4)
    p = dict(_distinct_payload(5), deterministic_vae_encode=False, num_images_per_prompt=nip)
    req = _Pending(_parse_payload(p, tiny_pipe, 2))
    srv._execute([req])
    np.testing.assert_array_equal(req.images, tiny_pipe(**_parse_payload(p, tiny_pipe, 2)))


def test_batched_num_images_per_prompt(tiny_pipe):
    srv = _batched_server(tiny_pipe, max_batch=2)
    payloads = [dict(_distinct_payload(s), num_images_per_prompt=2) for s in (1, 7)]
    reqs = [_Pending(_parse_payload(p, tiny_pipe, 2)) for p in payloads]
    srv._execute(reqs)
    for p, r in zip(payloads, reqs):
        assert len(r.images) == 2
        solo = tiny_pipe(**_parse_payload(p, tiny_pipe, 2))
        for k in range(2):
            assert np.abs(solo[k].astype(np.int16) - r.images[k].astype(np.int16)).max() <= 1


def test_drain_splits_incompatible(tiny_pipe):
    srv = _batched_server(tiny_pipe, max_batch=8)
    a1 = _Pending(_parse_payload(_distinct_payload(0), tiny_pipe, 2))
    a2 = _Pending(_parse_payload(_distinct_payload(1), tiny_pipe, 2))
    other = _Pending(_parse_payload(dict(_distinct_payload(2), num_inference_steps=3),
                                    tiny_pipe, 2))
    srv._queue.put(a2)
    srv._queue.put(other)
    assert srv._drain(a1) == [a1, a2]
    assert srv._queue.get_nowait() is other


def test_dispatch_is_no_batching_key(tiny_pipe):
    """Both dispatch values run the same loop, so requests that differ only
    in it share a batch."""
    srv = _batched_server(tiny_pipe, max_batch=8, dispatch="per_step")
    a = _Pending(_parse_payload(_distinct_payload(0), tiny_pipe, 2, srv.dispatch))
    b = _Pending(_parse_payload(dict(_distinct_payload(1), dispatch="scan"), tiny_pipe, 2))
    assert a.parsed["dispatch"] == "per_step" and b.parsed["dispatch"] == "scan"
    srv._queue.put(b)
    assert srv._drain(a) == [a, b]


def test_batch_window_accumulates(tiny_pipe):
    """Two requests 0.5 s apart land in one batched call."""
    srv = BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=4, batch_window_s=3.0)
    try:
        results = {}

        def go(k, delay):
            time.sleep(delay)
            results[k] = srv.generate(_distinct_payload(k))

        threads = [threading.Thread(target=go, args=(0, 0.0)),
                   threading.Thread(target=go, args=(1, 0.5))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        assert results[0]["batch_size"] == results[1]["batch_size"] == 2
        assert srv.stats()["batches"] == 1
    finally:
        srv.close()


def test_concurrent_http_roundtrip(tiny_pipe):
    """A live worker behind ThreadingHTTPServer: concurrent posts succeed,
    each equal to its solo reply within 1 uint8 level; healthz reports the
    batches."""
    http = _Http(BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=4))
    try:
        results = [None] * 3

        def go(k):
            results[k] = _post(http.url + "/generate", _distinct_payload(k))

        threads = [threading.Thread(target=go, args=(k,)) for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        for k, (status, body) in enumerate(results):
            assert status == 200, body
            assert len(body["images"]) == 1 and body["batch_size"] >= 1
            solo_status, solo_body = _post(http.url + "/generate", _distinct_payload(k))
            assert solo_status == 200
            diff = np.abs(_pixels(solo_body["images"][0]) - _pixels(body["images"][0]))
            assert diff.max() <= 1, f"seed {k}: max diff {diff.max()}"
        status, stats = _get(http.url + "/healthz")
        assert stats["requests"] == 6 and stats["batches"] >= 2 and stats["max_batch"] == 4
    finally:
        http.close()


def test_worker_error_recovery(tiny_pipe):
    """A request the pipeline refuses (no depth on a depth-conditioned
    model) gets a 400 and the worker serves the next one."""
    http = _Http(BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=2))
    try:
        bad = _distinct_payload(0)
        del bad["depth"]
        status, body = _post(http.url + "/generate", bad)
        assert status == 400 and "depth" in body["error"]
        status, body = _post(http.url + "/generate", _distinct_payload(1))
        assert status == 200, body
    finally:
        http.close()


@pytest.mark.parametrize("max_batch", [1, 2])
def test_backpressure_503(tiny_pipe, max_batch):
    srv = BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=max_batch,
                                 max_queue=1)
    srv.close()          # no worker: queued items stay pending
    srv._queue.put(_Pending(_parse_payload(_distinct_payload(0), tiny_pipe, 2)))
    with pytest.raises(OverloadedError):
        srv.generate(_distinct_payload(1))
    assert srv.stats()["rejected"] == 1
    first = srv._queue.get_nowait()
    srv._execute([first])
    assert len(first.images) == 1 and srv._queue.qsize() == 0
    http = _Http(BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=max_batch,
                                        max_queue=0))
    try:
        status, body = _post(http.url + "/generate", _distinct_payload(2))
        assert status == 503 and "queue full" in body["error"]
    finally:
        http.close()


def test_dispatch_per_step_payload(served):
    """dispatch="per_step" runs the same loop: the same bytes."""
    s1, b1 = _post(served + "/generate", _payload())
    s2, b2 = _post(served + "/generate", dict(_payload(), dispatch="per_step"))
    assert s1 == s2 == 200 and b1["images"] == b2["images"]
    s3, b3 = _post(served + "/generate", dict(_payload(), dispatch="loop"))
    assert s3 == 400 and "loop" in b3["error"]


def test_warmup_runs_solo_and_full_batch(tiny_pipe):
    srv = BatchingPipelineServer(tiny_pipe, default_steps=2, max_batch=2)
    try:
        serve.warmup(srv, H, 2, depth=True)
        assert srv.requests == 1 and srv.batched_requests >= 2
    finally:
        srv.close()


class _CardPipe:
    """What the server reads of a pipeline on a card, recording
    `enable_cuda_graphs`."""

    device = torch.device("cuda")
    enabled = ()

    def enable_cuda_graphs(self, max_keys):
        self.enabled += (max_keys,)

    def graph_stats(self):
        return {"captures": 8, "replays": 400, "eager_steps": 0}


@pytest.mark.parametrize("on_card", [False, True])
def test_server_enables_cuda_graphs_on_a_card_only(tiny_pipe, on_card):
    """A long-lived server steps on CUDA graphs where its pipeline is on a
    card; a CPU pipeline stays as it is.  stats() and /healthz carry the
    pipeline's graph counters."""
    pipe = _CardPipe() if on_card else tiny_pipe
    srv = _batched_server(pipe, max_batch=4)
    if on_card:
        assert pipe.enabled == (8,)              # 2 x max_batch step shapes kept
        assert srv.stats()["graphs"] == {"captures": 8, "replays": 400, "eager_steps": 0}
    else:
        assert tiny_pipe._graphs is None
        assert srv.stats()["graphs"] == {"captures": 0, "replays": 0, "eager_steps": 0}


def test_ip_adapter_payload_batched_matches_solo():
    """The normals ip_adapter mode through the server: the (1, 3) mean normal
    as a nested list, two requests batched equal their solo calls."""
    pipe = _tiny_pipe(ip=True)
    srv = _batched_server(pipe, max_batch=2)
    payloads = [dict(_distinct_payload(s), normals=[[0.0, 0.6 * s, 0.8]]) for s in (0, 1)]
    reqs = [_Pending(_parse_payload(p, pipe, 2)) for p in payloads]
    srv._execute(reqs)
    for p, r in zip(payloads, reqs):
        solo = pipe(**_parse_payload(p, pipe, 2))
        assert np.abs(solo[0].astype(np.int16) - r.images[0].astype(np.int16)).max() <= 1


def _argv(*extra):
    return ["--base_model_path", "/nonexistent", "--brushnet_path", "/nonexistent",
            "--device", "cpu", *extra]


def test_attention_backend_xla_matches_jax(tmp_path):
    """`--attention_backend xla` (refused before it was ported) reaches
    every attention of the pipeline `build_pipeline` makes, and a request
    through it gives the JAX server's pipeline under the JAX "xla" backend
    on the same folder and payload (initial noise from the payload's seed
    with numpy, the VAE encode at its mode): fp32, within 1 uint8 level."""
    import jax.numpy as jnp

    from reflecting_reality_tpu.ops import attention as j_attention
    from reflecting_reality_tpu_torch.core.io import load_pretrained, save_pretrained
    from reflecting_reality_tpu_torch.ops.attention import Attention
    from tests.test_torch_cli import write_tiny_base

    base = write_tiny_base(str(tmp_path / "base"))
    unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    torch.manual_seed(0)
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    with torch.no_grad():
        for p in brushnet.parameters():
            if not p.abs().max() > 0:
                p.normal_(0.0, 0.05)
    save_pretrained(brushnet, str(tmp_path / "bn"))
    argv = ["--base_model_path", base, "--brushnet_path", str(tmp_path / "bn"),
            "--depth_conditioning_mode", "concat", "--weight_dtype", "fp32",
            "--attention_backend", "xla"]
    pipe = serve.build_pipeline(serve.build_parser().parse_args(argv + ["--device", "cpu"]))
    attns = [m for mod in (pipe.unet, pipe.brushnet, pipe.vae) for m in mod.modules()
             if isinstance(m, Attention)]
    assert attns and {m.attention_backend for m in attns} == {"xla"}
    before = j_attention.get_attention_backend()
    j_attention.set_attention_backend("xla")      # what JAX's serve.main does with the flag
    try:
        jpipe = j_serve.build_pipeline(j_serve.build_parser().parse_args(argv))
        payload = _distinct_payload(0)
        noise = np.random.RandomState(0).standard_normal((1, H // 8, W // 8, 4)).astype(
            np.float32)
        got = pipe(**_parse_payload(payload, pipe, 2), latents=noise)[0]
        want = np.asarray(jpipe(**j_serve._parse_payload(payload, jpipe, 2),
                                latents=jnp.asarray(noise)))[0]
    finally:
        j_attention.set_attention_backend(before)
    assert got.shape == want.shape == (H, W, 3) and got.std() > 0
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_data_parallel_pads_the_bucket(tmp_path, monkeypatch):
    """`--data_parallel` (refused before item 16 was ported) builds the
    pipeline with `enable_data_parallel(make_mesh())`, here two visible
    devices (a mesh of two CPU entries).  A batch pads with copies of its
    last request until it divides by the mesh (JAX tests/test_serve.py:
    371-401): one request runs as 2, three as 4, two as 2; the padded
    images are dropped and each request's image is its solo call's
    without data parallelism, within one uint8 level."""
    from reflecting_reality_tpu_torch.core.io import load_pretrained, save_pretrained
    from reflecting_reality_tpu_torch.parallel import mesh
    from tests.test_torch_cli import write_tiny_base

    base = write_tiny_base(str(tmp_path / "base"))
    unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    with torch.no_grad():
        for p in brushnet.parameters():
            if not p.abs().max() > 0:
                p.normal_(0.0, 0.05)
    save_pretrained(brushnet, str(tmp_path / "bn"))
    monkeypatch.setattr(mesh, "make_mesh", lambda **kw: (torch.device("cpu"),) * 2)
    args = serve.build_parser().parse_args([
        "--base_model_path", base, "--brushnet_path", str(tmp_path / "bn"),
        "--depth_conditioning_mode", "concat", "--weight_dtype", "fp32", "--data_parallel",
        "--device", "cpu"])
    pipe = serve.build_pipeline(args)
    assert pipe._dp_mesh == (torch.device("cpu"),) * 2
    payloads = [_distinct_payload(k) for k in range(3)]
    pipe.disable_data_parallel()
    solo = [pipe(**_parse_payload(p, pipe, 2))[0] for p in payloads]
    pipe.enable_data_parallel((torch.device("cpu"),) * 2)
    sizes = []
    real_call = type(pipe).__call__

    def call(self, *a, **kw):
        sizes.append(len(kw["prompt"]))
        return real_call(self, *a, **kw)

    monkeypatch.setattr(type(pipe), "__call__", call)
    srv = _batched_server(pipe, max_batch=4)
    for group in ([0], [0, 1, 2], [1, 2]):
        reqs = [_Pending(_parse_payload(payloads[k], pipe, 2)) for k in group]
        srv._execute(reqs)
        for k, r in zip(group, reqs):
            assert r.batch_size == len(group) and len(r.images) == 1
            assert np.abs(r.images[0].astype(np.int16) - solo[k].astype(np.int16)).max() <= 1
    assert sizes == [2, 4, 2]


@pytest.mark.parametrize("policy", ["default", "select_all"])
def test_int8_flag_quantizes_the_served_pipeline(tmp_path, monkeypatch, policy):
    """`--int8` (which raised before the int8 mode was ported) builds the
    server's pipeline with `enable_int8()`, as JAX's build_pipeline does: on
    the tiny checkpoint the default policy selects nothing and it raises
    JAX's ValueError; with every layer selected the UNet and BrushNet run
    in int8 and serve a batch of two requests.  A batch shares one
    activation scale a layer (JAX's per-tensor absmax over the batch), so
    its images need not equal the solo calls'; both come out whole."""
    from reflecting_reality_tpu_torch.core.io import load_pretrained, save_pretrained
    from reflecting_reality_tpu_torch.ops import quant
    from tests.test_torch_cli import write_tiny_base

    base = write_tiny_base(str(tmp_path / "base"))
    unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    save_pretrained(BrushNetModel.from_unet(unet, conditioning_channels=6), str(tmp_path / "bn"))
    args = serve.build_parser().parse_args([
        "--base_model_path", base, "--brushnet_path", str(tmp_path / "bn"),
        "--depth_conditioning_mode", "concat", "--weight_dtype", "fp32", "--int8",
        "--device", "cpu"])
    if policy == "default":
        with pytest.raises(ValueError, match="no kernels selected"):
            serve.build_pipeline(args)
        return
    monkeypatch.setattr(quant, "default_select", quant.select_all)
    pipe = serve.build_pipeline(args)
    assert len(quant.int8_modules(pipe.unet)) > 50 and quant.int8_modules(pipe.brushnet)
    srv = _batched_server(pipe, max_batch=2)
    payloads = [_distinct_payload(k) for k in (0, 1)]
    reqs = [_Pending(_parse_payload(p, pipe, 2)) for p in payloads]
    srv._execute(reqs)
    for p, r in zip(payloads, reqs):
        solo = pipe(**_parse_payload(p, pipe, 2))
        assert solo.shape == r.images.shape and np.isfinite(r.images).all()


def test_parser_keeps_the_jax_flags():
    port = {a.dest for a in serve.build_parser()._actions}
    jax_flags = {a.dest for a in j_serve.build_parser()._actions}
    assert jax_flags <= port and port - jax_flags == {"device"}


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _argv()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(argv[:-2])
