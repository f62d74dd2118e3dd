"""The harness as data and as a command: both cells, their traffic kinds
and model families, and every metric load from ``BENCHMARK.json`` and
their files; the command refuses a machine
without a card (no CPU fallback) and a directory without the port; a
run's last line has the contract's keys only, ``checks`` last; and no
module of JAX or of the JAX package is loaded."""
import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import kinds
from perfbench.lib import bench, drive, flops, trace
from small import small_cell

ROOT = bench.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_cells_and_metrics_load_as_data():
    b = bench.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.chips == 1
        kind = kinds.load(cell.traffic["kind"])
        assert callable(kind.Kind) and kind.FAULTS and len(kind.ENTRY) == 2
        assert flops.per_call(cell.config, cell.traffic) > 0
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits["limits"])
        cell.model_config()
        for m in cell.per_layer:
            assert callable(bench.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(b["paths"][0] + "/")


def test_readers_find_nothing_in_an_empty_trace():
    ctx = {"cell": bench.load_cell("mamba2-1.3b.train"),
           "trace": trace.Trace(), "launches": {}, "memory_peak_bytes": 0}
    for m in bench.benchmark()["per_layer"]:
        assert bench.metric_reader(m["name"])(ctx) is None, m["name"]


def _command(args, cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = _command(["--workload", "mamba2-1.3b.train", "--seed",
                    str(2**31 + 5), "--seconds", "1", "--trace", "0"], ROOT)
    assert got.returncode != 0 and got.stdout == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(["--workload", "mamba2-1.3b.prefill", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], tmp_path)
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_keys(traced):
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run
    cell = small_cell("mamba2-1.3b.prefill", "bfloat16")
    res = drive.run(cell, 2**31 + 3, 0.2, traced, torch.device("cpu"),
                    time.perf_counter())
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": res["peak"]}
    line = json.loads(json.dumps(run.result_line(cell, res, traced, device)))
    want = KEYS[:5] + (["breakdown"] if traced else []) + KEYS[5:]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxonomy", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.train", sys)
    assert run.forbidden_modules() == ["repro"]


RUN_AND_LIST = """
import sys, time, torch
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/perfbench/tests",
                {root!r} + "/perfbench"]
from small import small_cell
from perfbench.lib import drive
import run
for name in ("mamba2-1.3b.train", "mamba2-1.3b.prefill"):
    drive.run(small_cell(name, "bfloat16"), 11, 0.2, True,
              torch.device("cpu"), time.perf_counter())
print(run.forbidden_modules(), "repro_torch" in sys.modules)
"""


def test_a_run_loads_no_jax():
    got = subprocess.run([sys.executable, "-c",
                          RUN_AND_LIST.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.split("\n")[-2] == "[] True"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.mamba2, perfbench.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))"
            % str(ROOT))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert got.stdout.strip() == "[]", got.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-1.3b.train", "mamba2-1.3b.prefill"])
def test_a_cell_runs_on_the_card(card, name):
    got = _command(["--workload", name, "--seed", str(2**31 + 99),
                    "--seconds", "5", "--trace", "0"], ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"] is True, line["checks"]
