"""The open-loop schedule repeats from the seed, every seed gets the same
sizes and arrivals, and latency runs from the due time."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from bench_h100 import traffic
from bench_h100.drivers import serve_open_loop as serve

PARAMS = {"rate": 1.1, "prompt_words": [3, 60], "mask_area": [0.05, 0.4], "resolution": 64,
          "num_inference_steps": 2, "guidance_scale": 7.5}


def test_schedule_repeats_from_the_seed():
    a = traffic.open_loop_schedule(PARAMS, 2 ** 31 + 17, 45.0)
    assert a == traffic.open_loop_schedule(PARAMS, 2 ** 31 + 17, 45.0)
    b = traffic.open_loop_schedule(PARAMS, 2 ** 31 + 18, 45.0)
    assert a != b
    for r in a + b:
        assert traffic.request_arrays(r, 64)["image"].dtype == np.uint8
    r = a[3]
    for k, v in traffic.request_arrays(r, 64).items():
        assert np.array_equal(v, traffic.request_arrays(r, 64)[k])


def test_every_seed_gets_the_same_sizes_and_arrivals():
    a = traffic.open_loop_schedule(PARAMS, 11, 45.0)
    b = traffic.open_loop_schedule(PARAMS, 12, 45.0)
    assert len(a) == len(b) == round(1.1 * 45)

    def gaps(s):
        return np.sort(np.diff([r["offset"] for r in s] + [45.0]))

    assert np.allclose(gaps(a), gaps(b))
    assert sorted(len(r["prompt"].split()) for r in a) == sorted(len(r["prompt"].split())
                                                                 for r in b)
    assert all(0.0 <= r["offset"] < 45.0 for r in a)
    areas = [r["rect"][2] * r["rect"][3] / 64 ** 2 for r in a]
    assert 0.02 < min(areas) and max(areas) < 0.5


def test_png_round_trip():
    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 256, (16, 12, 3), dtype=np.uint8),
                rng.integers(0, 256, (9, 7), dtype=np.uint8)):
        out = traffic.png_decode(traffic.png_encode(arr))
        assert np.array_equal(out.reshape(arr.shape), arr)


def test_png_decode_reads_every_filter():
    """A hand-filtered image (Sub, Up, Average, Paeth rows) decodes exactly."""
    import struct
    import zlib

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (4, 5, 3)).astype(np.int32)
    raw, prev = b"", np.zeros(15, np.int32)
    for r, f in enumerate((1, 2, 3, 4)):
        cur = img[r].reshape(-1)
        left = np.concatenate([[0, 0, 0], cur[:-3]])
        upleft = np.concatenate([[0, 0, 0], prev[:-3]])
        if f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    assert np.array_equal(traffic.png_decode(png), img.astype(np.uint8))


class _Slow(BaseHTTPRequestHandler):
    """Serves one request at a time, SERVICE_S each: later arrivals queue."""

    lock = threading.Lock()
    SERVICE_S = 0.4

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with self.lock:
            time.sleep(self.SERVICE_S)
        body = json.dumps({"images": []}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_latency_runs_from_the_due_time():
    """Requests due close together at a server that serves one at a time:
    each latency holds the queueing behind the earlier ones, and the last
    is near n x the service time, which a clock started at the service's
    start would not see."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    params = dict(PARAMS, rate=20.0)
    seconds = 0.3
    try:
        client = serve.start_client(f"http://127.0.0.1:{httpd.server_address[1]}", params, 3,
                                    seconds, [])
        results = serve.client_window(client, time.perf_counter() + 1.5, seconds)
    finally:
        httpd.shutdown()
    lat, failed = serve.latencies_of(results, seconds)
    n = len(results)
    assert failed == 0 and n == 6
    assert max(lat) >= (n - 1) * _Slow.SERVICE_S
    assert all(r["done"] - r["due"] == pytest_approx(x) for r, x in zip(results, lat))
    assert all(r["sent"] - r["due"] < 0.1 for r in results)


def pytest_approx(x):
    import pytest

    return pytest.approx(x)


def test_quantile_matches_numpy():
    xs = list(np.random.default_rng(0).random(45))
    for q in (0.5, 0.9):
        assert abs(serve.quantile(xs, q) - float(np.quantile(xs, q))) < 1e-12
