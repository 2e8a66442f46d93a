"""The control that sets the upper readings of `flux-fill-closed`'s limits,
run on the card at the cell's own size (never by the benchmark's own runs):

    python3 -m bench_h100.control_flux --seeds A,B,C [--seconds 20]

Each seed runs the cell for a short window and then its check with the
reference computed in float8 e4m3 (`reference.models.QUANT = "fp8"`, the
step below the configuration's bf16) in the program's place: `pred_gap`,
the float8 reference's velocities' worst relative gap to the float32
reference's at the program's latents, and `replay_off4`, the program's
velocities replayed and decoded in float8 against the same replay decoded
in float32.  Those readings meet the cell's own limits, so a sound control
reads `correct: false`.  Each seed prints one JSON line: the result line's
`correct` and checks, and the worst of every reading the check printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from bench_h100 import harness


def readings(seed: int, seconds: float) -> dict:
    """One short run of the cell under the control -> its checks and the
    worst of every reading the check printed."""
    from bench_h100 import run as entry

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = entry.main(["--workload", "flux-fill-closed", "--seed", str(seed), "--seconds",
                         repr(seconds), "--trace", "0"], control="fp8")
    if rc != 0:
        raise RuntimeError(f"the run exited {rc}: {err.getvalue()[-3000:]}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    found = [json.loads(t[t.index("{"):t.index("}") + 1])
             for t in err.getvalue().splitlines() if t.startswith("reading ")]
    joint = [t.split("joint attentions a step: ", 1)[1] for t in err.getvalue().splitlines()
             if "joint attentions a step: " in t]
    return {"seed": seed, "correct": line["correct"], "joint_attentions_a_step": joint[-1:],
            "checks": {k: v["value"] for k, v in line["checks"].items()},
            "worst": {k: max(f[k] for f in found) for k in found[0]},
            "images_per_s": line["metrics"].get("images_per_s", {}).get("value")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.use_caches()
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        res = readings(seed, args.seconds)
        print(json.dumps(dict(res, gpu=torch.cuda.get_device_name(0))), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
