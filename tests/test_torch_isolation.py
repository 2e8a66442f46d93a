"""The PyTorch port stands alone: neither the package (cli/serve.py
included) nor chip_smoke.py imports jax, flax, the JAX package or the
safetensors package (the port reads and writes the format itself), the
serving path answers a request with them blocked, the training CLI's latent-cache path
imports no file-format package, the inference CLI's `--image_mode` path
imports no h5py, and on CPU tensors the kernel wrappers take their plain
versions without launching (their counters stay 0)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.test_torch_helpers import one_thread_env, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "reflecting_reality_tpu_torch")
FORBIDDEN = ("jax", "flax", "reflecting_reality_tpu", "safetensors")


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports_in_source():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_imports_with_jax_blocked():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files()
    )
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + "".join(f"import {m}\n" for m in mods)
        + "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=one_thread_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result, both
    in the checkout and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT), (str(alone), tmp_path)):
        res = subprocess.run([sys.executable, script], cwd=cwd, env=one_thread_env(),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and '"ok"' not in res.stdout, (res.stdout, res.stderr)


def test_cpu_tensors_take_the_plain_versions():
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn
    from reflecting_reality_tpu_torch.ops.attention import dot_product_attention

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                gn.group_norm_silu_fwd)
    before = (fa.flash_attention_fwd.launches, gn.group_norm_silu_fwd.launches)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 4, 4)).astype(np.float32))
    w, b = torch.ones(8), torch.zeros(8)
    torch.testing.assert_close(gn.group_norm_silu(x, w, b, 4, 1e-5, True),
                               gn.group_norm_plain(x, w, b, 4, 1e-5, True), rtol=0, atol=0)
    q = torch.from_numpy(rng.standard_normal((1, 2048, 1, 8)).astype(np.float32))
    torch.testing.assert_close(fa.flash_attention(q, q, q), fa.attention_plain(q, q, q),
                               rtol=0, atol=0)
    torch.testing.assert_close(dot_product_attention(q, q, q), fa.attention_plain(q, q, q),
                               rtol=0, atol=0)
    # with gradients: torch autograd of the plain versions, no autograd Function
    xg, qg = x.clone().requires_grad_(True), q[:, :64].clone().requires_grad_(True)
    y = gn.group_norm_silu(xg, w, b, 4, 1e-5, True)
    o = fa.flash_attention(qg, qg, qg)
    assert not isinstance(y.grad_fn, gn.GroupNormSiLU._backward_cls)
    assert not isinstance(o.grad_fn, fa.FlashAttention._backward_cls)
    (y.sum() + o.sum()).backward()
    assert xg.grad is not None and qg.grad is not None
    assert (fa.flash_attention_fwd.launches, gn.group_norm_silu_fwd.launches) == before == (0, 0)
    assert all(fn.launches == 0 and not fn.launches_by_shape for fn in wrappers)


CACHE_PATH_RUN = r'''
import os, sys
from reflecting_reality_tpu_torch.cli import train

root = sys.argv[1]
out = os.path.join(root, "run")
for extra in ([], ["--device_cache", "--steps_per_dispatch", "2"]):
    train.main(["--pretrained_model_name_or_path", os.path.join(root, "base"),
                "--train_data_dir", root, "--precomputed_latents_dir",
                os.path.join(root, "cache"), "--output_dir", out,
                "--logging_dir", os.path.join(out, "logs"), "--depth_conditioning_mode",
                "concat", "--train_batch_size", "2", "--max_train_steps", "2",
                "--checkpointing_steps", "1", "--mixed_precision", "bf16", "--report_to",
                "none", "--validation_steps", "0", "--device", "cpu", *extra])
assert sorted(os.listdir(out)) == ["args.json", "checkpoint-1", "checkpoint-2", "logs"]
print(sorted(m for m in ("h5py", "pandas", "PIL", "safetensors", "msgpack") if m in sys.modules))
'''


def test_cli_cache_path_imports_no_file_format_packages(tmp_path):
    """The training CLI on a latent-moments cache (what the card runs) takes
    nothing from h5py, pandas, PIL, safetensors or msgpack, in a process of
    its own."""
    import csv

    from reflecting_reality_tpu_torch.data.latent_cache import cache_name
    from tests.test_torch_cli import write_tiny_base

    write_tiny_base(str(tmp_path / "base"))
    rows = [{"uid": f"u{i}", "path": f"obj/{i}.hdf5", "auto_caption": f"cube {i}"}
            for i in range(4)]
    with open(tmp_path / "train.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    (tmp_path / "cache").mkdir()
    r = np.random.RandomState(0)
    for i, row in enumerate(rows):
        np.savez(tmp_path / "cache" / cache_name(row, i),
                 latent_moments=r.randn(4, 4, 8).astype(np.float16),
                 cond_latent_moments=r.randn(4, 4, 8).astype(np.float16),
                 masks=np.ones((4, 4, 1), np.float32), depths=np.zeros((4, 4, 1), np.float32))
    res = subprocess.run([sys.executable, "-c", CACHE_PATH_RUN, str(tmp_path)], cwd=ROOT,
                         env=one_thread_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


IMAGE_MODE_RUN = r'''
import os, sys
sys.modules["jax"] = None
from reflecting_reality_tpu_torch.cli import test
from reflecting_reality_tpu_torch.core.io import load_pretrained, save_pretrained
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel

root = sys.argv[1]
unet = load_pretrained(UNet2DConditionModel, os.path.join(root, "base"), subfolder="unet")
save_pretrained(BrushNetModel.from_unet(unet, conditioning_channels=6), os.path.join(root, "bn"))
test.main(["--brushnet_path", os.path.join(root, "bn"), "--base_model_path",
           os.path.join(root, "base"), "--train_data_dir", os.path.join(root, "msd"),
           "--output_dir", os.path.join(root, "out"), "--image_mode", "--resolution", "64",
           "--depth_conditioning_mode", "concat", "--num_inference_steps", "1",
           "--num_images_per_validation", "2", "--device", "cpu"])
print(sorted(os.listdir(os.path.join(root, "out"))))
print(sorted(m for m in ("h5py", "jax") if sys.modules.get(m) is not None))
'''


def test_test_cli_image_mode_imports_no_h5py(tmp_path):
    """The inference CLI on an `--image_mode` folder (what the card runs:
    it has no h5py) imports no h5py, in a process of its own."""
    from tests.test_torch_cli import write_tiny_base
    from tests.test_torch_test_cli import write_image_mode_data

    write_tiny_base(str(tmp_path / "base"))
    write_image_mode_data(str(tmp_path / "msd"), 2, 64)
    res = subprocess.run([sys.executable, "-c", IMAGE_MODE_RUN, str(tmp_path)], cwd=ROOT,
                         env=one_thread_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-2:] == ["['msd0.png', 'msd1.png']", "[]"], res.stdout


SERVE_RUN = r'''
import json, sys, threading, urllib.request
for m in ("jax", "flax", "reflecting_reality_tpu", "safetensors"):
    sys.modules[m] = None
import numpy as np
import torch
from http.server import ThreadingHTTPServer
from reflecting_reality_tpu_torch.cli import serve
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.ip_adapter import NormalProjModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)

cfg = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2, cross_attention_dim=32,
           norm_num_groups=4, layers_per_block=2)
pipe = StableDiffusionBrushNetPipeline(
    vae=AutoencoderKL(block_out_channels=(8, 8, 8, 8), norm_num_groups=4),
    text_encoder=CLIPTextModel(vocab_size=1000, hidden_size=32, num_hidden_layers=1,
                               num_attention_heads=2, intermediate_size=64),
    tokenizer=HashTokenizer(vocab_size=1000), unet=UNet2DConditionModel(ip_num_tokens=4, **cfg),
    brushnet=BrushNetModel(conditioning_channels=6, **cfg), depth_conditioning_mode="concat",
    normals_conditioning_mode="ip_adapter", normal_proj=NormalProjModel(32), device="cpu")
pipe.enable_deep_cache(2)
pipe.enable_vae_tiling(num_tiles=2, overlap=1)
server = serve.BatchingPipelineServer(pipe, default_steps=3, max_batch=2)
httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
threading.Thread(target=httpd.serve_forever, daemon=True).start()
try:
    body = json.dumps({"prompt": "a mirror", "image": np.zeros((32, 32, 3)).tolist(),
                       "mask": np.ones((32, 32, 3)).tolist(),
                       "depth": np.zeros((32, 32, 1)).tolist(), "normals": [[0, 0, 1]]})
    req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/generate",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        print(r.status, len(json.loads(r.read())["images"]))
finally:
    httpd.shutdown()
    server.close()
'''


def test_serving_path_runs_with_jax_blocked():
    """cli/serve.py's server answers a request (ip_adapter mode, DeepCache,
    VAE tiling: every module of the serving path, lazy imports included) in
    a process where jax, flax, the JAX package and safetensors cannot be
    imported."""
    res = subprocess.run([sys.executable, "-c", SERVE_RUN], cwd=ROOT, env=one_thread_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "200 1", res.stdout


INT8_BASELINE_RUN = r'''
import sys
for m in ("jax", "flax", "reflecting_reality_tpu", "safetensors"):
    sys.modules[m] = None
import numpy as np
import torch
from reflecting_reality_tpu_torch.baseline.sd_inpainting import SDInpaintingPipeline
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.ops import quant
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)

cfg = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2, cross_attention_dim=32,
           norm_num_groups=4, layers_per_block=2)
parts = lambda: dict(vae=AutoencoderKL(block_out_channels=(8, 8, 8, 8), norm_num_groups=4),
                     text_encoder=CLIPTextModel(vocab_size=1000, hidden_size=32,
                                                num_hidden_layers=1, num_attention_heads=2,
                                                intermediate_size=64),
                     tokenizer=HashTokenizer(vocab_size=1000))
kw = dict(prompt="a mirror", image=np.zeros((32, 32, 3)), mask=np.ones((32, 32, 3)),
          depth=np.zeros((32, 32, 1)), num_inference_steps=2)
pipe = StableDiffusionBrushNetPipeline(
    **parts(), unet=UNet2DConditionModel(**cfg),
    brushnet=BrushNetModel(conditioning_channels=6, **cfg), depth_conditioning_mode="concat",
    device="cpu")
n = pipe.enable_int8(select=quant.select_all)
a = pipe(**kw)
base = SDInpaintingPipeline(**parts(), unet=UNet2DConditionModel(in_channels=10, **cfg),
                            depth_conditioning_mode="concat", device="cpu")
b = base(**kw)
print(n > 0, a.shape, b.shape, quant.int8_mm.launches, dict(quant.int8_mm.launches_by_shape))
'''


def test_int8_and_baseline_paths_run_with_jax_blocked():
    """The int8 pipeline and the SD-inpainting baseline pipeline run in a
    process where jax, flax, the JAX package and safetensors cannot be
    imported; on CPU tensors `int8_mm` takes its plain version (no launch
    counted)."""
    res = subprocess.run([sys.executable, "-c", INT8_BASELINE_RUN], cwd=ROOT,
                         env=one_thread_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == \
        "True (1, 32, 32, 3) (1, 32, 32, 3) 0 {}", res.stdout
