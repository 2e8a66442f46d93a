"""Cells, configurations and metrics are found by name, and a new cell is
one new file."""

import json
import shutil
import subprocess
import sys

from bench_h100 import harness


def test_every_name_in_benchmark_json_has_its_file():
    bench = harness.benchmark_json()
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert harness.load_config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert int(cell["chips"]) == w["chips"]
        harness.driver(cell["kind"])
        for name in harness.per_layer_names(w["name"], bench):
            assert callable(harness.metric_reader(name))
        assert "setup_s" in harness.end_to_end_names(w["name"], bench)
    for m in bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_a_new_cell_is_picked_up_from_its_file_alone(tmp_path, monkeypatch):
    for sub in ("workloads", "configs", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / sub)
    cell = json.loads((tmp_path / "workloads" / "sd15-serve-poisson.json").read_text())
    cell["params"]["rate"] = 0.5
    (tmp_path / "workloads" / "sd15-serve-slow.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "serve.queue_s.slow.py").write_text(
        "def read(run):\n    return run.data.get('queue_s')\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    assert "sd15-serve-slow" in harness.cells()
    assert harness.load_cell("sd15-serve-slow")["params"]["rate"] == 0.5
    bench = harness.benchmark_json()
    bench["per_layer"].append({"name": "serve.queue_s.slow", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "server",
                               "moves": "latency_p90_s", "workloads": ["sd15-serve-slow"]})
    bench["end_to_end"][0]["workloads"].append("sd15-serve-slow")
    assert harness.per_layer_names("sd15-serve-slow", bench) == ["serve.queue_s.slow"]
    assert harness.end_to_end_names("sd15-serve-slow", bench) == ["latency_p90_s", "setup_s"]

    class Run:
        data = {"queue_s": 1.5}

    assert harness.metric_reader("serve.queue_s.slow")(Run) == 1.5


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reflecting_reality_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "reflecting_reality_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "reflecting_reality_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "reflecting_reality_tpu.core"]


def test_a_run_that_loaded_jax_prints_no_result(tmp_path):
    """The entry exits non-zero with no line when JAX is in sys.modules once
    the window has closed (a stand-in module named jax is loaded here)."""
    (tmp_path / "jax.py").write_text("")
    code = ("import sys, torch; sys.path.insert(0, %r); import jax\n"
            "from bench_h100 import run\n"
            "from bench_h100.tests import tiny\n"
            "torch.set_num_threads(2)\n"
            "cell = tiny.cell('sd15-train-bs4', **tiny.TRAIN)\n"
            "sys.exit(run.main(['--workload', 'sd15-train-bs4', '--seed', '5', '--seconds', '1',"
            " '--trace', '0'], device='cpu', cfg=tiny.config(), cell=cell))" % str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(harness.ROOT), timeout=600)
    assert res.returncode == 3, res.stderr[-2000:]
    assert res.stdout.strip() == ""
    assert "JAX or the JAX package was loaded: ['jax']" in res.stderr


def test_no_card_no_result():
    """Without enough CUDA devices the entry exits non-zero and prints no line."""
    res = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                          "sd15-serve-poisson", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=str(harness.ROOT), timeout=300,
                         env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""
