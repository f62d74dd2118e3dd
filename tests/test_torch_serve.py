"""The port's serving engine against the reference's dense ``ServeEngine``.

Greedy decoding on SMOKE qwen3-0.6b in fp32 with the reference's weights,
block prefill on, and requests admitted mid-run into recycled slots. As in
``tests/multidev/check_ring_decode.py`` the two engines run in lockstep
and the reference's token is committed to both, so their schedules stay
identical; at every sampled position the port must pick the reference's
token unless the reference's top two logits are an fp near-tie.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch

from test_torch_reference import (  # noqa: F401 (fixture)
    ref,
    reference_model,
    smoke_fp32,
)

from repro_torch.configs import ServeConfig
from repro_torch.models import params_from_reference
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sample import sample
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend

TIE_GAP = 5e-3
SCFG = dict(max_batch=4, max_seq_len=32, temperature=0.0, prefill_chunk=8)


def _schedule(vocab):
    """[(tick, prompt, max_new)]: 4 requests up front, 3 admitted later."""
    rng = np.random.default_rng(0)
    out = []
    for tick in (0, 0, 0, 0, 5, 6, 9):
        p = rng.integers(0, vocab, int(rng.integers(1, 12))).astype(np.int32)
        out.append((tick, p, int(rng.integers(3, 7))))
    return out


def _drive(engine, schedule, logits_fn, commit_tokens=None):
    """Run ``engine`` to completion on ``schedule``. Returns per tick the
    (sampling mask, logits); commits ``commit_tokens[tick]`` when given,
    else its own greedy tokens."""
    record = []
    tick = 0
    while tick <= max(t for t, _, _ in schedule) or engine.sched.busy:
        for t, p, n in schedule:
            if t == tick:
                engine.sched.submit(p, max_new_tokens=n)
        engine._admit()
        toks, active, sampling = engine.sched.plan()
        logits = logits_fn(engine.backend.step(toks, active))
        nxt = logits.argmax(-1) if commit_tokens is None \
            else commit_tokens[tick]
        engine.sched.commit(sampling, nxt)
        record.append((sampling, logits, nxt))
        tick += 1
    return record


def assert_lockstep(record, ref_record):
    """Same sampling masks at every tick, and at every sampled position the
    reference's token unless its top two logits are an fp near-tie."""
    assert len(record) == len(ref_record)
    sampled = ties = 0
    for (s, lg, _), (rs, rlg, rtok) in zip(record, ref_record):
        np.testing.assert_array_equal(s, rs)
        for b in np.where(s)[0]:
            sampled += 1
            if lg[b].argmax() != rtok[b]:
                gap = rlg[b].max() - np.partition(rlg[b], -2)[-2]
                assert gap < TIE_GAP, (b, gap)
                ties += 1
    assert sampled > 20 and ties <= 1


@pytest.fixture(scope="module")
def reference_run(ref):
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.engine import ServeEngine as RServeEngine
    rcfg, cfg = smoke_fp32()
    _, rparams, tree = reference_model(rcfg)
    engine = RServeEngine(rcfg, RServeConfig(**SCFG), rparams)
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: np.asarray(x, np.float32))
    return cfg, tree, record


BACKENDS = [pytest.param(0, "dense", id="dense")] + [
    pytest.param(n, mode, id=f"ring{n}-{mode}")
    for n in (2, 4) for mode in ("baseline", "sw", "xqueue", "qlr")]


@pytest.mark.parametrize("n_pe,mode", BACKENDS)
def test_greedy_tokens_match_reference_engine(reference_run, n_pe, mode):
    cfg, tree, ref_record = reference_run
    scfg = ServeConfig(**SCFG)
    params = params_from_reference(tree, cfg, device="cpu")
    if n_pe:
        backend = RingShardedBackend(cfg, scfg, params, n_pe, mode,
                                     device="cpu")
    else:
        backend = DecodeBackend(cfg, scfg, params, device="cpu")
    engine = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: x.numpy().astype(np.float32),
                    commit_tokens=[r[2] for r in ref_record])
    assert_lockstep(record, ref_record)


@pytest.mark.parametrize("backend", ["dense", "ring"])
def test_engine_run_completes_every_request(backend):
    """ServeEngine.run end to end on random weights: every request is
    served to its budget, including ones admitted into recycled slots."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("qwen3-0.6b")
    params = build_model(cfg).init(0, device="cpu")
    scfg = ServeConfig(max_batch=2, max_seq_len=32, prefill_chunk=8)
    be = RingShardedBackend(cfg, scfg, params, 2, "qlr", device="cpu") \
        if backend == "ring" else None
    engine = ServeEngine(cfg, scfg, params, backend=be, device="cpu")
    rids = [engine.submit(np.arange(n) % cfg.vocab_size, 4)
            for n in (0, 3, 9, 12)]
    engine.run(max_ticks=100)
    reqs = {r.rid: r for r in engine.sched.slot_req if r is not None}
    assert not reqs and not engine.pending and len(rids) == 4
    assert engine.metrics.counter("repro_tokens_total").value == 16


def test_sample_edge_contract():
    logits = torch.tensor([[0.0, float("nan"), 1.0],
                           [float("nan")] * 3,
                           [2.0, 2.0, -1.0]])
    assert sample(logits).tolist() == [2, 0, 0]
    g = torch.Generator().manual_seed(0)
    hot = sample(logits, g, temperature=1.0, top_k=1)
    assert hot.tolist() == [2, 0, hot[2].item()] and hot[2].item() in (0, 1)
    draws = {sample(logits[2:], g, temperature=1.0, top_k=2).item()
             for _ in range(50)}
    assert draws == {0, 1}            # tied top-k logits both stay sampleable


def test_schedule_serves_late_admissions(reference_run):
    """The scripted schedule admits three requests after the first four
    filled every slot, so they land in recycled slots; the lockstep record
    covers every token of every request."""
    cfg, _, record = reference_run
    budgets = sum(n for _, _, n in _schedule(cfg.vocab_size))
    assert sum(int(s.sum()) for s, _, _ in record) == budgets
    assert len(_schedule(cfg.vocab_size)) > SCFG["max_batch"]
