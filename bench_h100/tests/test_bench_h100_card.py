"""On the card (marker `cuda`; skipped elsewhere): each one-card cell runs
short and comes out correct, and each control comes out not correct under
the cell's limits at the cell's own size.

    python -m pytest -q -p no:cacheprovider -m cuda bench_h100/tests
"""

import json
import subprocess
import sys

import pytest

from bench_h100 import control, harness

pytestmark = pytest.mark.cuda

SEED = 3100000001


@pytest.mark.parametrize("cell", ["sd15-serve-poisson", "sd15-train-bs4", "sdxl-closed"])
def test_cell_runs_and_is_correct(card, cell):
    res = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "12", "--trace", "0"], capture_output=True,
                         text=True, cwd=str(harness.ROOT), timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["failed"] == 0


@pytest.mark.parametrize("cell", ["sd15-serve-poisson", "sdxl-closed"])
def test_image_control_fails_its_limit(card, cell):
    cell = harness.load_cell(cell)
    out = control.image_readings(cell, SEED, 12.0)
    limits = cell["limits"]
    assert all(out["exact"][k] <= v for k, v in limits.items()), out
    assert any(out["int8"][k] > v for k, v in limits.items()), out


def test_training_controls_fail_their_limits(card):
    cell = harness.load_cell("sd15-train-bs4")
    out = control.train_readings(harness.load_config(cell["config"]), cell, SEED, card)
    for fault in ("fp8", "half_batch"):
        assert any(out[fault][k] > cell["limits"][k] for k in cell["limits"]), (fault, out)
