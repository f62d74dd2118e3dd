"""The readers of the port's program spans (``metrics/*_ms.train.py``,
``metrics/*_ms.prefill.py`` that import ``repro_torch.obs.trace``) on a
made-up recording and a made-up ``Trace``: their sums, none on spans
without a device time, none on a wrong count of spans or roots, and the
SSD glue's subtraction of the kernel's traced time. A traced run of the
small cells records one root a traced call, on the CPU and on the card;
on the card all seven read a value."""
import time

import pytest
import torch

from perfbench.lib import bench, drive
from perfbench.lib import trace as trace_lib
from repro_torch.obs import trace
from small import small_cell

TRAIN = ("forward_ms.train", "backward_ms.train", "recompute_ms.train",
         "optimizer_ms.train")
PREFILL = ("conv_ms.prefill", "ssd_glue_ms.prefill", "gated_norm_ms.prefill")
KERNEL_S = {"void ssd_chunks_kernel_mma<64>(...)": 0.004, "gemm": 1.0}


class Event:
    """A timing event whose time is set by the test (``at`` in ms)."""
    now = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = Event.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def recording(monkeypatch):
    """A clean recording, an armed tracer, and (with ``card``) stand-in
    CUDA events."""
    trace._roots.clear()
    trace._pool.clear()
    tr = trace.Tracer().arm()

    def card():
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
        monkeypatch.setattr(torch.cuda, "Event", Event)
    yield card
    tr.disarm()
    trace._roots.clear()
    trace._pool.clear()


def timed(name: str, ms: float, inner=()):
    """A span of ``ms`` device milliseconds around ``inner`` spans, which
    take their own ``ms`` out of it."""
    with trace.span(name):
        Event.now += ms - sum(args[1] for args in inner)
        for args in inner:
            timed(*args)


def train_step(layers: int, recompute: int, ms: float = 1.0):
    timed("train.step", 10 * ms, [
        ("train.forward", 4 * ms,
         [("mamba2.block", ms / layers)] * layers),
        ("train.backward", 5 * ms,
         [("mamba2.block", ms / layers / 2)] * recompute),
        ("train.optimizer", ms / 2)])


def prefill_call(layers: int, drop=()):
    parts = [("mamba2.conv", 0.25), ("mamba2.ssd", 0.5),
             ("mamba2.gated_norm", 0.125)]
    parts = [p for p in parts if p[0] not in drop]
    timed("prefill.step", 2.0 * layers,
          [("mamba2.block", 1.0, parts)] * layers)


def ctx(name: str, calls: int, kernel_s=None):
    return {"cell": bench.load_cell(name),
            "trace": trace_lib.Trace(calls=calls, kernel_s=kernel_s or {}),
            "launches": {}, "memory_peak_bytes": 0}


def read(name, c):
    return bench.metric_reader(name)(c)


def test_train_readers_sum_a_step(recording):
    recording()
    for k in (1, 2):
        train_step(48, 48, ms=k)
    c = ctx("mamba2-1.3b.train", 2)
    got = {m: read(m, c) for m in TRAIN}
    assert got["forward_ms.train"] == pytest.approx(4 * 1.5)
    assert got["backward_ms.train"] == pytest.approx(5 * 1.5)
    assert got["recompute_ms.train"] == pytest.approx(1.5 / 2)
    assert got["optimizer_ms.train"] == pytest.approx(1.5 / 2)
    c1 = ctx("mamba2-1.3b.train", 1)
    assert read("forward_ms.train", c1) == pytest.approx(8.0)


def test_train_readers_refuse_wrong_counts(recording):
    recording()
    train_step(48, 47)                             # a recompute lost
    c = ctx("mamba2-1.3b.train", 1)
    assert read("recompute_ms.train", c) is None
    assert read("forward_ms.train", c) is not None
    assert read("forward_ms.train", ctx("mamba2-1.3b.train", 2)) is None
    prefill_call(48)                               # the last root differs
    assert read("forward_ms.train", c) is None


def test_readers_find_nothing_on_spans_without_device_time(recording):
    train_step(48, 48)                             # no card: no events
    assert all(s.device_ms is None for s in trace.last_roots(1)[0].spans)
    c = ctx("mamba2-1.3b.train", 1)
    assert all(read(m, c) is None for m in TRAIN)
    prefill_call(48)
    c = ctx("mamba2-1.3b.prefill", 1, KERNEL_S)
    assert all(read(m, c) is None for m in PREFILL)


def test_prefill_readers_and_the_glue_subtraction(recording):
    recording()
    for _ in range(3):
        prefill_call(48)
    c = ctx("mamba2-1.3b.prefill", 3, KERNEL_S)
    assert read("conv_ms.prefill", c) == pytest.approx(48 * 0.25)
    assert read("gated_norm_ms.prefill", c) == pytest.approx(48 * 0.125)
    # 48 ssd spans of 0.5 ms a call, less 4 ms of kernel over 3 calls
    assert read("ssd_glue_ms.prefill", c) == pytest.approx(
        48 * 0.5 - 4.0 / 3)
    assert read("ssd_glue_ms.prefill",
                ctx("mamba2-1.3b.prefill", 3, {"gemm": 1.0})) is None
    prefill_call(48, drop=("mamba2.conv",))        # a call without conv
    c = ctx("mamba2-1.3b.prefill", 1, KERNEL_S)
    assert read("conv_ms.prefill", c) is None
    assert read("gated_norm_ms.prefill", c) == pytest.approx(48 * 0.125)


def test_readers_keep_quiet_on_a_port_without_spans(monkeypatch):
    import repro_torch.obs.trace as mod
    monkeypatch.delattr(mod, "mean_device_ms")
    for m in TRAIN:
        assert read(m, ctx("mamba2-1.3b.train", 1)) is None
    for m in PREFILL:
        assert read(m, ctx("mamba2-1.3b.prefill", 1, KERNEL_S)) is None


def _traced_runs(dev):
    """Each small cell traced on ``dev``: (cell, the run's reader
    context, the kept roots of its traced calls, what the span readers
    read right after the run)."""
    out = []
    for name in ("mamba2-1.3b.train", "mamba2-1.3b.prefill"):
        cell = small_cell(name, "bfloat16")
        trace._roots.clear()
        res = drive.run(cell, 2**31 + 21, 0.2, True, dev,
                        time.perf_counter())
        c = res["_ctx"]
        names = TRAIN if cell.traffic["kind"] == "train" else PREFILL
        out.append((cell, c, trace.last_roots(trace.MAX_ROOTS),
                    {m: read(m, c) for m in names}))
    return out


def test_a_traced_cpu_run_records_a_root_a_traced_call():
    for cell, c, roots, got in _traced_runs(torch.device("cpu")):
        layers = cell.config["model"]["num_layers"]
        kind = cell.traffic["kind"]
        assert len(roots) == c["trace"].calls >= 1
        assert {r.name for r in roots} == {f"{kind}.step"}
        blocks = [s for s in roots[-1].spans if s.name == "mamba2.block"]
        assert len(blocks) == (2 * layers if kind == "train" else layers)
        assert set(got.values()) == {None}                 # no card


@pytest.mark.cuda
def test_the_span_readers_read_on_the_card(card):
    for cell, c, _, got in _traced_runs(card):
        assert all(v is not None and v > 0 for v in got.values()), got
        if cell.traffic["kind"] == "train":
            parts = sum(got[m] for m in ("forward_ms.train",
                                         "backward_ms.train",
                                         "optimizer_ms.train"))
            window_ms = 1e3 * c["trace"].window_s / c["trace"].calls
            assert parts <= window_ms * 1.05, (parts, window_ms)
            assert got["recompute_ms.train"] < got["backward_ms.train"]
