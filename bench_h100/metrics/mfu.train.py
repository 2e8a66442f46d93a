"""The whole step's share of the card's bf16 peak: model FLOPs of the
samples the window trained (counted by the reference on the meta device)
over the window's length times 989 TFLOP/s."""

from bench_h100.harness import PEAK_BF16_FLOPS
from bench_h100.modelflops import train_flops_per_sample


def read(run):
    if not run.data.get("window_s"):
        return None
    p = run.cell["params"]
    flops = run.data["samples"] * train_flops_per_sample(run.cfg, int(p["batch_size"]),
                                                         int(p["resolution"]))
    return 100.0 * flops / (run.data["window_s"] * PEAK_BF16_FLOPS)
