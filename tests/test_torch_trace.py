"""The port's program spans (``repro_torch.obs.trace``) on the CPU.

Off (no profiler recording, no Tracer armed) a span is a shared no-op
context: no ``record_function``, no clock read, no CUDA event. On, it
records its name, parent, root and recompute flag, a ``record_function``
range while the profiler records, host times on the profiler's clock, and
on a card a pair of pooled CUDA events (here a counting stand-in, as this
machine has no card). A SMOKE Mamba2 training step records one
``train.step`` root with the forward, backward and optimizer under it and
remat's recompute of every block under the backward. No JAX.
"""
from __future__ import annotations

import itertools
import json
import threading
from collections import Counter
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.models import zamba
from repro_torch.obs import trace
from repro_torch.train import step

LAYERS = 3
MAMBA2_PARTS = ("mamba2.in_proj", "mamba2.conv", "mamba2.ssd",
                "mamba2.gated_norm", "mamba2.out_proj")


@pytest.fixture(autouse=True)
def fresh_recording(monkeypatch):
    """Each test starts with no kept roots, an empty pool, nothing armed
    and no backward open, whatever earlier tests of the process left."""
    monkeypatch.setattr(trace, "_armed", 0)
    monkeypatch.setattr(trace, "_backward", [])
    trace._roots.clear()
    trace._pool.clear()
    yield
    trace._roots.clear()
    trace._pool.clear()


class FakeEvent:
    """A CUDA timing event's stand-in: each ``record`` reads a shared tick,
    so a span's ``elapsed_time`` is the records between its two, plus 1."""
    tick = itertools.count()
    made = 0
    records = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        FakeEvent.records += 1
        self.at = next(FakeEvent.tick)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA "initialised", with counting events."""
    FakeEvent.made = FakeEvent.records = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return FakeEvent


@pytest.fixture
def counted(monkeypatch, fake_card):
    """Counts of ``record_function`` ranges entered anywhere, host clock
    reads by the span code and CUDA events recorded."""
    seen = Counter()
    real_rf = torch.autograd.profiler.record_function

    def rf(name, *a, **k):
        seen["record_function"] += 1
        return real_rf(name, *a, **k)

    class Clock:
        def __getattr__(self, name):
            seen["clock"] += 1
            import time
            return getattr(time, name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    monkeypatch.setattr(trace, "time", Clock())
    return seen


def _smoke(layers=LAYERS):
    return replace(get_smoke_config("mamba2-1.3b"), num_layers=layers,
                   remat="full")


def _ssd_inputs(bh=4, bg=2, nc=2, l=16, p=8, n=8, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)
    return (rand(bh, nc, l, p),
            torch.nn.functional.softplus(rand(bh, nc, l, 1)),
            -torch.exp(0.3 * rand(bh, 1, 1, 1)),
            0.3 * rand(bg, nc, l, n), 0.3 * rand(bg, nc, l, n))


def _block_forward():
    """One SMOKE Mamba2 block forward (its five part spans and the SSD
    kernel's)."""
    cfg = _smoke(1)
    params = zamba.MambaLM(cfg).init(seed=0, device="cpu")
    x = torch.randn(2, 32, cfg.d_model)
    with torch.no_grad():
        return zamba.mamba_block(params["layers"][0], x, cfg)


def test_off_enters_nothing_reads_no_clock_records_no_event(counted):
    assert trace.span("mamba2.block") is trace.span("train.step")
    _block_forward()
    ins = [t.requires_grad_(True) for t in _ssd_inputs()]
    outs = sk.ssd_chunks(*ins, nheads=4, ngroups=2)
    torch.autograd.grad(outs[0].sum(), ins)          # the backward's label
    assert trace.last_roots(8) == []
    assert dict(counted) == {} and FakeEvent.made == 0
    tr = trace.Tracer().arm()
    counted.clear()
    try:
        _block_forward()
    finally:
        tr.disarm()
    spans = 1 + len(MAMBA2_PARTS) + 1                # block, parts, kernel
    assert dict(counted) == {"clock": 2 * spans}     # no profiler recording
    assert FakeEvent.records == 2 * spans


def test_spans_nest_under_the_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _block_forward()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(("mamba2.", "kernel.")):
            assert e.name not in ranges, e.name
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    assert set(ranges) == {"mamba2.block", *MAMBA2_PARTS,
                           "kernel.ssd_chunks"}
    lo, hi = ranges["mamba2.block"]
    for name in MAMBA2_PARTS:
        assert lo <= ranges[name][0] <= ranges[name][1] <= hi, name
    klo, khi = ranges["kernel.ssd_chunks"]
    slo, shi = ranges["mamba2.ssd"]
    assert slo <= klo <= khi <= shi
    (root,) = trace.last_roots(8)
    assert root.name == "mamba2.block" and root.spans[-1] is root
    assert {s.parent.name for s in root.spans if s is not root} == {
        "mamba2.block", "mamba2.ssd"}
    assert all(s.device_ms is None for s in root.spans)     # no card


def test_tracer_export_shares_the_profilers_clock(tmp_path):
    """The last of two rounds is compared: the first ``record_function``
    of a process pays for setting it up."""
    tr = trace.Tracer().arm()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with tr.span("tick", cat="serve"):
                    with trace.span("prefill.step"):
                        torch.ones(64).sum()
    finally:
        tr.disarm()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    got = json.loads(path.read_text())
    base_us = got.get("baseTimeNanoseconds", 0) / 1e3
    prof_ts = {e["name"]: e["ts"] + base_us for e in sorted(
        got["traceEvents"], key=lambda e: e.get("ts", 0))
        if e.get("name") in ("tick", "prefill.step") and e.get("ph") == "X"}
    mine = {e["name"]: e for e in tr.to_chrome()["traceEvents"]}
    assert set(prof_ts) == set(mine) == {"tick", "prefill.step"}
    for name, ts in prof_ts.items():
        assert abs(mine[name]["ts"] - ts) < 100.0, (name, mine[name], ts)
    args = mine["prefill.step"]["args"]
    assert mine["prefill.step"]["cat"] == "program"
    assert args["parent"] is None and args["device_ms"] is None


@pytest.fixture(scope="module")
def smoke_step():
    """One SMOKE Mamba2 training step (remat full, LAYERS layers) under a
    CPU profiler, after an untraced one."""
    cfg, tcfg = _smoke(), TrainConfig()
    state = step.init_state(cfg, tcfg, device="cpu")
    train_step = step.make_train_step(cfg, tcfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "targets": tok.roll(-1, 1)}
    state, _ = train_step(state, batch)
    assert trace.last_roots(8) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch)
    roots = trace.last_roots(8)
    return roots, Counter(e.name for e in prof.events())


def test_train_step_records_forward_backward_optimizer(smoke_step):
    roots, _ = smoke_step
    (root,) = roots
    assert root.name == "train.step" and root.parent is None
    children = [s.name for s in root.spans if s.parent is root]
    assert children == ["train.forward", trace.BACKWARD, "train.optimizer"]
    assert all(s.root is root for s in root.spans)
    by = {s.name: s for s in root.spans if s.parent is root}
    blocks = [s for s in root.spans if s.name == "mamba2.block"]
    fwd = [s for s in blocks if not s.recompute]
    rec = [s for s in blocks if s.recompute]
    assert len(fwd) == len(rec) == LAYERS
    assert all(s.parent is by["train.forward"] for s in fwd)
    assert all(s.parent is by[trace.BACKWARD] for s in rec)
    heads = [s for s in root.spans if s.name == "model.head"]
    assert len(heads) == 1 and heads[0].parent is by["train.forward"]
    for s in root.spans:
        if s.name in MAMBA2_PARTS:
            assert s.parent.name == "mamba2.block"
            assert s.recompute == s.parent.recompute
    bwd = [s for s in root.spans if s.name == "ssd_chunks_backward"]
    assert len(bwd) == LAYERS
    assert all(s.parent is by[trace.BACKWARD] and s.recompute for s in bwd)
    assert not any(s.recompute for s in (by["train.forward"],
                                         by[trace.BACKWARD],
                                         by["train.optimizer"]))


def test_train_step_spans_reach_the_profiler(smoke_step):
    _, names = smoke_step
    for name in ("train.step", "train.forward", trace.BACKWARD,
                 "train.optimizer", "model.head"):
        assert names[name] == 1, name
    for name in ("mamba2.block", *MAMBA2_PARTS, "kernel.ssd_chunks"):
        assert names[name] == 2 * LAYERS, name
    assert names["ssd_chunks_backward"] == LAYERS


def test_ssd_backward_label_under_the_profiler():
    """``chip_smoke.py`` reads ``ssd_chunks_backward`` under its
    profiler."""
    ins = [t.requires_grad_(True) for t in _ssd_inputs()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = sk.ssd_chunks(*ins, nheads=4, ngroups=2)
        torch.autograd.grad(outs[0].sum(), ins)
    names = Counter(e.name for e in prof.events())
    assert names["ssd_chunks_backward"] == 1
    assert names["kernel.ssd_chunks"] == 1


def test_a_worker_thread_span_takes_the_open_backward_as_parent():
    tr = trace.Tracer().arm()
    seen = []

    def worker():
        with trace.span("mamba2.block") as s:
            with trace.span("mamba2.conv") as inner:
                seen.extend([s, inner])

    try:
        with trace.span("train.step") as root:
            with trace.span(trace.BACKWARD) as bwd:
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        t = threading.Thread(target=worker)       # no backward open
        t.start()
        t.join()
    finally:
        tr.disarm()
    block, conv, alone, _ = seen
    assert block.parent is bwd and block.recompute and block.root is root
    assert conv.parent is block and conv.recompute
    assert block.thread != root.thread
    assert alone.parent is None and not alone.recompute
    assert [r.name for r in trace.last_roots(8)] == ["train.step",
                                                      "mamba2.block"]


def test_recording_keeps_the_last_64_roots(fake_card):
    tr = trace.Tracer().arm()
    try:
        for i in range(trace.MAX_ROOTS + 6):
            with trace.span("prefill.step"):
                with trace.span("mamba2.conv"):
                    pass
    finally:
        tr.disarm()
    kept = trace.last_roots(1000)
    assert len(kept) == trace.MAX_ROOTS
    assert kept[0].start_ns < kept[-1].start_ns
    # a dropped root gives its 4 events back and the next root takes them
    assert fake_card.made == 4 * (trace.MAX_ROOTS + 1)
    assert len(trace._pool) == 4
    assert trace.mean_device_ms(3, "prefill.step", "mamba2.conv") == 1.0
    assert len(trace._pool) == 4 + 3 * 2               # read: returned
    tr.arm()
    with trace.span("train.step"):
        pass
    tr.disarm()
    assert fake_card.made == 4 * (trace.MAX_ROOTS + 1)
    assert len(trace.last_roots(1000)) == trace.MAX_ROOTS


def test_mean_device_ms_sums_a_root_and_refuses_wrong_counts(fake_card):
    tr = trace.Tracer().arm()
    try:
        for _ in range(2):
            with trace.span("train.step"):
                with trace.span("train.forward"):
                    for _ in range(3):
                        with trace.span("mamba2.block"):
                            pass
                with trace.span(trace.BACKWARD):
                    with trace.span("mamba2.block"):
                        pass
    finally:
        tr.disarm()
    # each forward block: records 2 apart (none in between); forward: 7
    assert trace.mean_device_ms(2, "train.step", "train.forward") == 7.0
    assert trace.mean_device_ms(2, "train.step", "mamba2.block", 3,
                                recompute=False) == 3.0
    assert trace.mean_device_ms(2, "train.step", "mamba2.block", 1,
                                recompute=True) == 1.0
    assert trace.mean_device_ms(2, "train.step", "mamba2.block", 4) == 4.0
    assert trace.mean_device_ms(2, "train.step", "mamba2.block", 3) is None
    assert trace.mean_device_ms(3, "train.step", "train.forward") is None
    assert trace.mean_device_ms(2, "prefill.step", "train.forward") is None
    assert trace.mean_device_ms(0, "train.step", "train.forward") is None


def test_tracer_arming_and_export(fake_card, tmp_path):
    null = trace.NullTracer().arm()
    assert trace._armed == 0 and trace.span("x") is trace._OFF
    null.disarm()
    with trace.span("prefill.step"):
        pass                                   # before any arming: off
    tr = trace.Tracer()
    assert tr.arm() is tr and tr.arm() is tr and trace._armed == 1
    with trace.span("prefill.step"):
        with trace.span("model.head"):
            pass
    tr.disarm()
    tr.disarm()
    assert trace._armed == 0
    with tr.span("tick", cat="serve"):
        pass
    path = tmp_path / "t.json"
    tr.dump(path)
    events = json.loads(path.read_text())["traceEvents"]
    prog = [e for e in events if e["cat"] == "program"]
    assert [e["name"] for e in prog] == ["prefill.step", "model.head"]
    head = prog[1]["args"]
    assert head["parent"] == prog[0]["args"]["id"] == head["root"]
    assert head["device_ms"] == 1.0 and head["recompute"] is False
    assert [e["name"] for e in events if e["cat"] == "serve"] == ["tick"]
    assert trace.NullTracer().to_chrome()["traceEvents"] == []
