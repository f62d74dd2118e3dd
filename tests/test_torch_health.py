"""The port's self-healing serving layer (``serve/health.py``), its checked
and telemetry ring backend, ``ServeEngine.export_observability`` and the
serving launcher (``launch/serve.py``), on SMOKE qwen3-0.6b on the CPU.

* A ring backend with checked links and telemetry on serves the greedy
  tokens of the reference's dense engine, in lockstep as
  ``tests/test_torch_serve.py`` holds the plain backends.
* The chaos property of the reference's
  ``tests/multidev/check_fault_recovery.py``, for every fault kind: a fault
  armed for one guarded step at tick 4 trips the probe on qlr, xqueue and
  sw, so the ladder steps down three rungs within that step to
  ``ring-baseline``; every request completes, the tokens are bitwise those
  of a clean run force-degraded at the same tick, and serving goes on.
  Here the fault also lands in the decode stream itself (a ring of 4 with
  a batch of 4 engages ring decode), so the rollback has real damage to
  undo: the cache the faulted step wrote in place.
"""
from __future__ import annotations

import json
import types
from dataclasses import replace

import numpy as np
import pytest

import torch

from test_torch_serve import (  # noqa: F401 (fixture)
    SCFG,
    _drive,
    _schedule,
    assert_lockstep,
    ref,
    reference_run,
)

from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.core import collective_matmul as cm
from repro_torch.core import faults, queues
from repro_torch.core import topology as tp
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_reference
from repro_torch.serve import health as health_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.health import FatalFaultError, HealthConfig
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend

KINDS = [k for k in faults.KINDS if k != "none"]
FAULT_TICK = 3
CHAOS_SCFG = dict(max_batch=4, max_seq_len=32, temperature=0.0)


@pytest.mark.parametrize("n_pe,mode", [(2, "qlr"), (4, "qlr"), (4, "sw")])
def test_checked_telemetry_backend_matches_reference_engine(
        reference_run, n_pe, mode):
    cfg, tree, ref_record = reference_run
    scfg = ServeConfig(**SCFG)
    params = params_from_reference(tree, cfg, device="cpu")
    backend = RingShardedBackend(cfg, scfg, params, n_pe, mode, checked=True,
                                 telemetry=True, device="cpu")
    engine = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: x.numpy().astype(np.float32),
                    commit_tokens=[r[2] for r in ref_record])
    assert_lockstep(record, ref_record)
    assert backend.link_health() == {"tag_errors": 0, "csum_errors": 0}
    stats = backend.link_stats()
    assert stats["pushes"] > 0 and stats["payload_bytes"] > 0
    assert stats["tag_errors"] == stats["csum_errors"] == 0


# ---------------------------------------------------------------------------
# chaos: ladder recovery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_model():
    cfg = replace(get_smoke_config("qwen3-0.6b"), dtype="float32",
                  param_dtype="float32")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _chaos_engine(cfg, params, **backend_kw):
    scfg = ServeConfig(**CHAOS_SCFG)
    be = RingShardedBackend(cfg, scfg, params, 4, "qlr", checked=True,
                            device="cpu", **backend_kw)
    return ServeEngine(cfg, scfg, params, backend=be, health=HealthConfig(),
                       device="cpu")


def _chaos_drive(eng, vocab, fault_kind):
    """Five requests (one admitted into a recycled slot); at FAULT_TICK
    either arm ``fault_kind`` for one engine step or (the clean reference)
    force-degrade three rungs."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = rng.integers(0, vocab, size=int(rng.integers(2, 8))) \
            .astype(np.int32)
        eng.submit(p, max_new_tokens=4)
    reqs = list(eng.pending)
    ticks = 0
    while eng.sched.busy and ticks < 60:
        eng._admit()
        if ticks == FAULT_TICK and fault_kind is None:
            for _ in range(3):
                eng.monitor.force_degrade()
            eng.step()
        elif ticks == FAULT_TICK:
            with faults.inject(faults.FaultSpec(fault_kind, hop=1, device=2,
                                                seed=7)):
                eng.step()
        else:
            eng.step()
        ticks += 1
    return reqs, [tuple(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def clean_ladder(chaos_model):
    cfg, params = chaos_model
    eng = _chaos_engine(cfg, params)
    reqs, toks = _chaos_drive(eng, cfg.vocab_size, None)
    assert eng.backend.name == "ring-baseline+checked"
    assert all(r.status == "done" for r in reqs)
    return toks


@pytest.mark.parametrize("kind", KINDS)
def test_fault_recovery_down_the_ladder(chaos_model, clean_ladder, kind):
    cfg, params = chaos_model
    eng = _chaos_engine(cfg, params, telemetry=True)
    reqs, toks = _chaos_drive(eng, cfg.vocab_size, kind)
    events = eng.monitor.events
    degrades = [e for e in events if e.kind == "degrade"]
    detected = [e for e in events if e.kind == "link_fault"]
    assert eng.backend.name == "ring-baseline+checked"
    assert len(degrades) == 3 and len(detected) == 3
    assert all(e.tick == FAULT_TICK + 1 for e in degrades + detected)
    assert [e.detail for e in degrades] == [
        "ring-qlr+checked -> ring-xqueue+checked",
        "ring-xqueue+checked -> ring-sw+checked",
        "ring-sw+checked -> ring-baseline+checked"]
    assert all(r.status == "done" and r.done for r in reqs)
    assert toks == clean_ladder                     # recovery leaves no trace
    m = eng.metrics
    assert m.counter("repro_degradations_total").value == 3
    assert m.counter("repro_rollbacks_total").value == 3
    assert m.gauge("repro_mode_rung").value == 3
    assert eng.backend.link_stats()["pushes"] > 0   # totals survive rebuilds
    assert all(a.data_ptr() == b.data_ptr() for a, b in     # no second copy
               zip(_leaves(eng.backend.params), _leaves(eng._params)))

    # post-recovery: the degraded engine keeps serving new work normally
    post = eng.sched.submit(np.asarray([5, 7, 11], np.int32),
                            max_new_tokens=3)
    n_events = len(events)
    eng.run(max_ticks=60)
    assert post.status == "done" and len(post.out_tokens) == 3
    assert len(eng.monitor.events) == n_events


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_fault_lands_in_the_decode_stream(chaos_model):
    """Unchecked and unmonitored, the same fault poisons some decode rows
    (not all): it hits the model's own hops, not only the probe's."""
    cfg, params = chaos_model
    be = RingShardedBackend(cfg, ServeConfig(**CHAOS_SCFG), params, 4, "qlr",
                            device="cpu")
    toks, active = np.ones((4, 1), np.int32), np.ones(4, bool)
    snap = be.snapshot_cache()
    with faults.inject(faults.FaultSpec("corrupt", hop=1, device=2)):
        bad = be.step(toks, active)
    rows = torch.isfinite(bad).all(dim=-1)
    assert 0 < int(rows.sum()) < 4
    be.adopt_cache(snap)                             # undo the faulted step
    clean = be.step(toks, active)
    assert bool(torch.isfinite(clean).all())
    assert torch.equal(be.snapshot_cache()["layers"]["pos"],
                       snap["layers"]["pos"] + 1)


# ---------------------------------------------------------------------------
# the observers change nothing
# ---------------------------------------------------------------------------


def _counting(monkeypatch):
    counts = {"flash_carry": 0, "tile_matmul": 0}
    flash, tile = flash_ops.flash_carry, cm.tile_matmul

    def flash_counted(*a, **k):
        counts["flash_carry"] += 1
        return flash(*a, **k)

    def tile_counted(*a, **k):
        counts["tile_matmul"] += 1
        return tile(*a, **k)

    monkeypatch.setattr(flash_ops, "flash_carry", flash_counted)
    monkeypatch.setattr(cm, "tile_matmul", tile_counted)
    return counts


def test_observers_change_no_token_and_no_launch(chaos_model, monkeypatch):
    """The same requests served plain and served checked + telemetry +
    monitor give the same greedy tokens and the same kernel-wrapper calls
    per prefill and per decode step; the probe calls none."""
    cfg, params = chaos_model
    counts = _counting(monkeypatch)
    scfg = ServeConfig(max_batch=4, max_seq_len=32, prefill_chunk=8)
    runs = {}
    for observed in (False, True):
        be = RingShardedBackend(cfg, scfg, params, 4, "qlr",
                                checked=observed, telemetry=observed,
                                device="cpu")
        eng = ServeEngine(cfg, scfg, params, backend=be, device="cpu",
                          health=HealthConfig() if observed else None)
        rng = np.random.default_rng(1)
        reqs = [eng.sched.submit(rng.integers(0, cfg.vocab_size, n), 3)
                for n in (9, 4, 12, 6, 10)]
        per_tick = []
        while eng.sched.busy:
            before = dict(counts)
            eng._admit()
            eng.step()
            per_tick.append({k: counts[k] - before[k] for k in counts})
        runs[observed] = ([tuple(r.out_tokens) for r in reqs], per_tick)
        if observed:
            before = dict(counts)
            be._probe_links(faults.no_fault_vec())
            assert counts == before                 # the probe: no kernel
            assert eng.monitor.events == []
    (plain_toks, plain_ticks), (toks, ticks) = runs[False], runs[True]
    assert toks == plain_toks and all(len(t) == 3 for t in toks)
    assert ticks == plain_ticks
    assert all(t["flash_carry"] > 0 for t in ticks)
    assert any(t["tile_matmul"] > 0 for t in ticks)     # the prefill rings


# ---------------------------------------------------------------------------
# the other monitor paths
# ---------------------------------------------------------------------------


def test_nonfinite_rows_evicted_with_exact_rollback(chaos_model):
    """A NaN logit row indicts only that request: it is evicted, the
    step's in-place cache writes are rolled back, and the survivor's tokens
    are bitwise those of an undisturbed run."""
    cfg, params = chaos_model

    def run(poison):
        eng = _chaos_engine(cfg, params)
        victim = eng.sched.submit(np.array([5, 9, 13], np.int32), 4)
        survivor = eng.sched.submit(np.array([7, 2], np.int32), 4)
        for _ in range(3):
            eng._admit()
            eng.step()
        if poison:
            orig, fired = eng.backend.step, []

            def poisoned(tokens, active):
                logits = orig(tokens, active)
                if not fired:
                    fired.append(True)
                    logits = logits.clone()
                    logits[0] = float("nan")
                return logits
            eng.backend.step = poisoned
        eng.run()
        return eng, victim, survivor

    eng, victim, survivor = run(True)
    _, _, clean = run(False)
    assert victim.status == "error" and not victim.done
    assert victim.finish_reason == "non-finite logits"
    assert len(victim.out_tokens) == 1
    assert [e.kind for e in eng.monitor.events] == ["nonfinite"]
    assert survivor.done and survivor.out_tokens == clean.out_tokens


def test_deadline_trips_one_rung(chaos_model, monkeypatch):
    """A step over its wall-clock budget rolls back and degrades; the
    clock is read after the step (on the card, after a synchronize)."""
    cfg, params = chaos_model
    reads = []

    def clock():                 # the first guarded step takes "10 s"
        reads.append(None)
        return 10.0 if len(reads) == 2 else 0.0

    monkeypatch.setattr(health_lib, "time", types.SimpleNamespace(
        perf_counter=clock, sleep=lambda s: None))
    scfg = ServeConfig(**CHAOS_SCFG)
    be = RingShardedBackend(cfg, scfg, params, 4, "qlr", device="cpu")
    eng = ServeEngine(cfg, scfg, params, backend=be, device="cpu",
                      health=HealthConfig(deadline_s=5.0))
    req = eng.sched.submit(np.array([3, 4], np.int32), 2)
    eng.run(max_ticks=20)
    assert [e.kind for e in eng.monitor.events] == ["deadline", "degrade"]
    assert eng.backend.name == "ring-xqueue+checked"
    assert req.status == "done" and len(req.out_tokens) == 2


def test_ladder_exhaustion_is_fatal(chaos_model):
    cfg, params = chaos_model
    eng = ServeEngine(cfg, ServeConfig(max_batch=1, max_seq_len=32), params,
                      health=HealthConfig(max_retries=2), device="cpu")
    eng.backend.link_health = lambda: {"tag_errors": 1}
    req = eng.sched.submit(np.array([5, 9], np.int32), 3)
    with pytest.raises(FatalFaultError) as exc:
        eng.run()
    assert req.status == "failed" and not req.done
    assert exc.value.failed == [req] and not eng.sched.busy
    with pytest.raises(FatalFaultError):
        eng.monitor.force_degrade()


def test_snapshot_is_a_copy_and_tables_stay_trainable(chaos_model):
    """snapshot_cache copies (the model writes the cache in place);
    adopt_cache copies back and leaves the snapshot intact. Tables the
    checked links build while serving (under inference mode) stay normal
    tensors, so a later training step can save them."""
    cfg, params = chaos_model
    be = _chaos_engine(cfg, params).backend
    snap = be.snapshot_cache()
    be.step(np.ones((4, 1), np.int32), np.ones(4, bool))
    assert not torch.equal(be.cache["layers"]["pos"], snap["layers"]["pos"])
    kept = {k: v.clone() for k, v in snap["layers"].items()}
    be.adopt_cache(snap)
    be.step(np.ones((4, 1), np.int32), np.ones(4, bool))
    assert all(torch.equal(kept[k], snap["layers"][k]) for k in kept)
    for t in queues._pred_table(tp.ring("model", 4), torch.device("cpu")):
        assert not t.is_inference()
    x = torch.ones(4, 3, requires_grad=True)
    state, _, health = queues.stream(tp.ring("model", 4), x, 4,
                                     lambda s, b, t: s + b,
                                     torch.zeros(4, 3), "qlr", checked=True)
    state.sum().backward()
    assert torch.equal(x.grad, torch.full((4, 3), 4.0))
    assert int(health.sum()) == 0


# ---------------------------------------------------------------------------
# observability export and the launcher
# ---------------------------------------------------------------------------


def _read_outputs(metrics, trace):
    snap = json.loads(metrics.read_text())
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    return snap["counters"], spans


def test_export_observability_folds_link_telemetry(chaos_model, tmp_path):
    cfg, params = chaos_model
    from repro_torch.obs.trace import Tracer
    scfg = ServeConfig(max_batch=4, max_seq_len=32, prefill_chunk=8)
    be = RingShardedBackend(cfg, scfg, params, 4, "qlr", checked=True,
                            telemetry=True, device="cpu")
    eng = ServeEngine(cfg, scfg, params, backend=be, tracer=Tracer(),
                      health=HealthConfig(), device="cpu")
    eng.submit(np.arange(10) % cfg.vocab_size, 3)
    eng.run()
    paths = [tmp_path / n for n in ("m.json", "m.prom", "t.json")]
    eng.export_observability(*paths)
    counters, spans = _read_outputs(paths[0], paths[2])
    stats = be.link_stats()
    for k, v in stats.items():
        assert counters[f"repro_link_{k}_total"] == v
    assert stats["pushes"] > 0 and stats["mcast_bytes"] == 0
    assert "repro_link_payload_bytes_total" in paths[1].read_text()
    assert {"tick", "prefill", "decode", "probe", "sample"} <= spans
    be.set_telemetry(False)
    eng.submit(np.arange(4), 2)
    eng.run()
    assert be.link_stats() == stats                 # collection paused


def test_launcher_serves_on_the_cpu(tmp_path, capsys):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.json"
    engine, reqs = launch_serve.main([
        "--device", "cpu", "--backend", "ring", "--n-pe", "2", "--checked",
        "--monitor", "--telemetry", "--requests", "3", "--max-new", "3",
        "--prefill-chunk", "8", "--metrics-out", str(metrics),
        "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "served 3 requests (ring-qlr+checked), 9 tokens" in out
    assert all(r.status == "done" and len(r.out_tokens) == 3 for r in reqs)
    counters, spans = _read_outputs(metrics, trace)
    assert counters["repro_link_pushes_total"] > 0
    assert counters["repro_link_tag_errors_total"] == 0
    assert counters["repro_link_csum_errors_total"] == 0
    assert {"decode", "probe"} <= spans
    assert (tmp_path / "m.prom").exists()
    assert engine.monitor is not None and engine.monitor.events == []


def test_launcher_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        launch_serve.main(["--requests", "1"])


def test_dense_rung_and_backend_surface(chaos_model):
    """The last rung is the dense backend: no links, no probe, no stats."""
    cfg, params = chaos_model
    eng = _chaos_engine(cfg, params)
    for _ in range(4):
        eng.monitor.force_degrade()
    assert isinstance(eng.backend, DecodeBackend)
    assert not isinstance(eng.backend, RingShardedBackend)
    assert eng.backend.name == "dense" and eng.monitor._rung() == "dense"
    assert eng.backend.link_health() == {} and eng.backend.link_stats() == {}
    assert (eng.max_batch, eng.max_seq) == (4, 32)
    assert eng.model is eng.backend.model and eng.cache is eng.backend.cache
    assert eng.params is eng.backend.params
