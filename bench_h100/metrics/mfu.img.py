"""The whole call's share of the card's bf16 peak: model FLOPs of the
images the window finished (text encoders, VAE encode, 50 steps of BrushNet
and UNet at the CFG batch, VAE decode; counted by the reference on the meta
device) over the window's length times 989 TFLOP/s."""

from bench_h100.harness import PEAK_BF16_FLOPS
from bench_h100.modelflops import image_flops


def read(run):
    if not run.data.get("window_s"):
        return None
    p = run.cell["params"]
    flops = run.data["images"] * image_flops(run.cfg, int(p["resolution"]),
                                             int(p["num_inference_steps"]))
    return 100.0 * flops / (run.data["window_s"] * PEAK_BF16_FLOPS)
