"""The port's dry run, roofline analysis and perf launcher on the CPU.

The dry run runs a cell's step on fake tensors: a full-width cell that
could not be allocated here runs, its argument bytes are those of its
parameters, cache and batch, and nothing stays cached from the fake mode.
Its records go through ``roofline.analysis``, and ``launch.perf`` lists
the reference's variants (read from the reference's source: importing
its module sets ``XLA_FLAGS`` for the process) and records the
sharding-only ones as not applicable.
"""
from __future__ import annotations

import ast
import json
from dataclasses import replace
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.configs import (
    ShapeConfig,
    TrainConfig,
    get_config,
    get_shape,
    get_smoke_config,
)
from repro_torch.core import queues, topology
from repro_torch.launch import dryrun, perf
from repro_torch.models import build_model
from repro_torch.roofline import analysis, hw
from repro_torch.train import step as step_lib

REF_PERF = Path(__file__).resolve().parents[1] / "src/repro/launch/perf.py"


def _bytes(*trees) -> int:
    return dryrun.tree_bytes(trees)


def test_full_width_mixtral_decode_runs_unallocated():
    """mixtral-8x22b decode_32k at full width: 401.5 GB of parameters and
    cache, which this machine could not hold, dry-run on fake tensors."""
    rec = dryrun.run_cell("mixtral-8x22b", "decode_32k", device="cpu",
                          out_dir=None)
    assert rec["ok"], rec.get("traceback")
    cfg, shape = get_config("mixtral-8x22b"), get_shape("decode_32k")
    with FakeTensorMode():
        params = step_lib.params_shapes(cfg, "cpu")
        cache, _ = step_lib.cache_shapes(cfg, shape, "cpu")
        batch, _ = step_lib.batch_shapes(cfg, shape, "cpu")
        assert isinstance(params["embed"]["table"], FakeTensor)
    mem = rec["memory"]
    assert mem["argument_bytes"] == _bytes(params, cache, batch)
    assert mem["argument_bytes"] > 4e11
    assert not mem["fits"] and mem["peak_bytes"] > mem["argument_bytes"]
    assert rec["chips"] == 1 and rec["device"] == "cpu"
    assert rec["n_active_params"] == cfg.n_active_params
    counts = rec["counts"]
    # the dense dispatch gives each row expert_capacity(cfg, 1) = 16 slots
    # an expert, where the model FLOPs count the 2 experts a token takes:
    # 64 times the expert work (the reference's HLO counts the same)
    ratio = analysis.model_flops(rec) / counts["flops_per_device"]
    assert 1 / 64 < ratio < 1 / 32
    assert counts["by_kernel"] == {} and counts["link_bytes"] == 0


def test_shape_helpers_hold_the_real_trees_bytes():
    """The fake trees have the real trees' leaves, shapes and types: equal
    bytes (qwen3 SMOKE state, zamba2 SMOKE cache, whisper batch)."""
    cfg = get_smoke_config("qwen3-0.6b")
    tcfg = TrainConfig()
    fake = step_lib.state_shapes(cfg, tcfg, "cpu")
    real = step_lib.init_state(cfg, tcfg, 0, "cpu")
    assert _bytes(fake) == _bytes(real)
    zcfg = get_smoke_config("zamba2-1.2b")
    shape = ShapeConfig("cell", 64, 3, "decode")
    cache, axes = step_lib.cache_shapes(zcfg, shape, "cpu")
    model = build_model(zcfg)
    assert _bytes(cache) == _bytes(model.init_cache(3, 64, "cpu"))
    assert axes == model.cache_axes()
    wcfg = get_smoke_config("whisper-tiny")
    specs, axes = step_lib.batch_shapes(wcfg, ShapeConfig("c", 8, 2, "train"),
                                        "cpu")
    assert set(specs) == {"tokens", "targets", "frames"} == set(axes)
    assert specs["frames"].shape == (2, wcfg.enc_frames, wcfg.d_model)


def test_fake_tables_are_not_cached():
    """A table built under the dry run's fake mode is not kept: the next
    real call builds a real one."""
    topo = topology.ring("model", 4)
    queues._pred_index.cache_clear()
    with FakeTensorMode():
        pred, _ = queues._pred_index(topo, torch.device("cpu"))
        assert isinstance(pred, FakeTensor)
    pred, _ = queues._pred_index(topo, torch.device("cpu"))
    assert not isinstance(pred, FakeTensor)
    assert pred.tolist() == [3, 0, 1, 2]


def test_record_analysis_and_markdown(tmp_path, capsys):
    """A written record (whisper-tiny decode_32k on a ring of 2) through
    ``analyze_cell``, ``to_markdown`` and the analysis CLI."""
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "qlr", 2,
                          device="cpu", out_dir=tmp_path)
    path = tmp_path / "whisper-tiny__decode_32k__1xH100__qlr-pe2.json"
    assert json.loads(path.read_text())["ok"] and rec["ok"]
    row = analysis.analyze_cell(path)
    counts = rec["counts"]
    assert row["flops_per_device"] == counts["flops_per_device"]
    want = sum(f / hw.PEAK_FLOPS[k]
               for k, f in counts["flops_by_kind"].items())
    assert row["compute_s"] == pytest.approx(want)
    assert row["memory_s"] == counts["hbm_bytes_per_device"] / hw.HBM_BW
    assert row["step_s_bound"] == max(row["compute_s"], row["memory_s"])
    assert row["dominant"] in ("compute", "memory")
    assert 0 < row["link_s"] < row["memory_s"]
    assert row["by_kernel"]["flash_carry"]["launches"] == 4 * 2
    md = analysis.to_markdown([row])
    assert row["cell"] in md and md.count("\n") == 2
    analysis.main(["--dir", str(tmp_path),
                   "--out", str(tmp_path / "roofline.json")])
    out = capsys.readouterr().out
    assert "1 cells analyzed" in out
    assert f"{row['cell']}: {row['dominant']} bound -> " in out
    assert analysis.analyze_cell({"ok": False}) is None


def test_dryrun_cli(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                     "--device", "cpu", "--out", str(tmp_path)])
    assert done.value.code == 0
    assert "dryrun: 1/1 cells ok" in capsys.readouterr().out
    rec = json.loads(
        (tmp_path / "mamba2-1.3b__long_500k__1xH100.json").read_text())
    assert rec["counts"]["by_kernel"] == {}      # decode: the step scan
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                     "--device", "cpu", "--out", str(tmp_path),
                     "--skip-existing"])
    assert "skip (cached ok)" in capsys.readouterr().out


def test_dryrun_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", out_dir=tmp_path)
    assert not rec["ok"] and "no CUDA GPU" in rec["error"]


def _reference_variants() -> dict:
    tree = ast.parse(REF_PERF.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("VARIANTS not found in the reference's perf.py")


def test_perf_lists_the_reference_variants(capsys):
    ref_variants = _reference_variants()
    assert perf.VARIANTS == ref_variants
    perf.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    want = [f"{k}: {spec['arch']} x {spec['shape']}: "
            + ", ".join(v for v in spec if v not in ("arch", "shape"))
            for k, spec in ref_variants.items()]
    assert lines == want


def test_perf_sharding_variant_not_applicable(tmp_path, capsys):
    rec = perf.run_variant("internvl", "i2_pure_dp", device="cpu",
                           out_dir=tmp_path)
    assert "not applicable" in capsys.readouterr().out
    assert rec["ok"] is False and rec["applicable"] is False
    assert "parallelism" in rec["error"] and "counts" not in rec
    written = tmp_path / (perf.variant_name("internvl", "i2_pure_dp")
                          + ".json")
    assert json.loads(written.read_text())["applicable"] is False
    perf.report(perf_dir=tmp_path, base_dir=tmp_path)
    assert capsys.readouterr().out == ""     # nothing ok to report


def test_perf_variant_runs_and_reports(tmp_path, monkeypatch, capsys):
    """A variant that runs on one card (granite's xqueue ring, cut to 2
    layers for time) is recorded ok and reported."""
    small = replace(get_config("granite-34b"), num_layers=2)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: small if arch == "granite-34b"
                        else get_config(arch))
    rec = perf.run_variant("granite", "v2_xqueue_ring", device="cpu",
                           out_dir=tmp_path)
    assert rec["ok"], rec.get("traceback")
    assert rec["cell"] == "granite-34b__train_4k__1xH100__xqueue-pe4__" \
                          "v2_xqueue_ring"
    assert rec["counts"]["by_kernel"]["tile_matmul"]["launches"] > 0
    perf.report(perf_dir=tmp_path, base_dir=tmp_path)
    out = capsys.readouterr().out
    assert "### granite" in out and "| v2_xqueue_ring |" in out
