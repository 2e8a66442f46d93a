"""The whole FLUX.1 Fill call's share of the card's bf16 peak: model FLOPs
of the images the window finished (CLIP and T5, the VAE encode, 50
transformer forwards over 4608 joint tokens, the VAE decode; counted by
`reference/flux.py` on the meta device, `modelflops_flux.py`) over the
window's length times 989 TFLOP/s."""

from bench_h100.harness import PEAK_BF16_FLOPS
from bench_h100.modelflops_flux import image_flops


def read(run):
    if not run.data.get("window_s"):
        return None
    p = run.cell["params"]
    flops = run.data["images"] * image_flops(run.cfg, int(p["resolution"]),
                                             int(p["num_inference_steps"]))
    return 100.0 * flops / (run.data["window_s"] * PEAK_BF16_FLOPS)
