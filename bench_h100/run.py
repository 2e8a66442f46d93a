"""The benchmark's entry:

    python3 -m bench_h100.run --workload NAME --seed N --seconds S --trace 0|1

Runs one cell (`workloads/NAME.json`) on the card of the machine it starts
on: set-up from the seed, a measured window of S seconds, then the check
of what the window produced against the plain reference, and one JSON line
on standard output.  With `--trace 0` the line holds the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics (a profiler window inside
the run) and the device's busy and traced seconds.  It exits non-zero and
prints no line without enough cards, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the `perf_counter` clock (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()

import argparse  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from bench_h100 import harness  # noqa: E402


class Run:
    """One run's settings, and what its driver leaves for the readers."""

    def __init__(self, cell: dict, cfg: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float = T_START):
        self.cell, self.cfg, self.seed, self.seconds = cell, cfg, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.attempted = self.failed = 0
        self.e2e = {}             # end-to-end metric -> value
        self.checks = []          # {"name", "value", "limit", "ok"}
        self.data = {}            # what the per-layer readers read
        self.trace_obj = None     # trace.Trace of the profiler window
        self.device_extra = {}
        self.chips = int(cell.get("chips", 1))
        self.phases = {}          # set-up phase -> seconds since the process started

    def mark(self, phase: str) -> None:
        """The end of a set-up phase (imports, kernels, weights, warm-up)."""
        import time

        self.phases[phase] = time.perf_counter() - self.t_start

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append({"name": name, "value": float(value), "limit": float(limit),
                            "ok": bool(value <= limit)})

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, cfg: Optional[dict] = None, bench: Optional[dict] = None,
         cell: Optional[dict] = None, control: Optional[str] = None) -> int:
    """`device`, `cfg`, `bench` and `cell` are for the CPU tests: a device
    given skips the look for cards.  `control` ("int8") runs the cell with
    the program's own lower-precision path switched on (`control.py`)."""
    args = parse(argv)
    harness.use_caches()
    import torch

    cell = cell or harness.load_cell(args.workload)
    chips = int(cell.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    bench = bench or harness.benchmark_json()
    run = Run(cell, cfg or harness.load_config(cell["config"]), args.seed, args.seconds,
              bool(args.trace), torch.device(device))
    run.control = control
    drv = harness.driver(cell["kind"])
    run.mark("imports")
    drv.run(run)
    if run.phases:
        print("set-up phases, seconds since the process started: "
              + ", ".join(f"{k} {v:.3f}" for k, v in run.phases.items()), file=sys.stderr)

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics, breakdown, extra = {}, None, {}
    if args.trace:
        for name in harness.per_layer_names(cell["name"], bench):
            value = harness.metric_reader(name)(run)
            if value is not None:
                metrics[name] = (value, units[name])
        if run.trace_obj is not None:
            breakdown = run.trace_obj.breakdown()
            extra = {"busy_s": run.trace_obj.busy_s(), "window_s": run.trace_obj.wall_s}
    else:
        for name in harness.end_to_end_names(cell["name"], bench):
            if name in run.e2e:
                metrics[name] = (run.e2e[name], units[name])
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    info = (harness.device_info(torch, run.chips) if run.device.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    info.update(run.device_extra)
    harness.emit(run.correct, run.attempted, run.failed, metrics, info, run.checks, breakdown,
                 extra)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
