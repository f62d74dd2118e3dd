"""Host-side tracing: spans at the port's layer boundaries, and engine-tick
phases as Chrome trace-event JSON, viewable in Perfetto / chrome://tracing.

**Program spans.** ``with span("mamba2.conv"):`` marks a layer of the
port. A span records only while something asks for spans: a
``torch.profiler`` is recording, or an operator has armed a
:class:`Tracer` (``Tracer.arm``: ``launch/train.py --trace-out``,
``ServeEngine.run`` with a tracer). Otherwise ``span`` returns a shared
no-op context after one flag check: no ``record_function``, no clock
read, no CUDA event. A recorded span keeps

* its name, its parent, its root (the outermost span of its call: one a
  training step or a prefill call) and ``recompute``: whether it ran
  inside ``train.backward`` (remat's recompute of a forward span, or a
  backward kernel's launch);
* host start and end in monotonic nanoseconds, exported on the Unix
  clock the profiler's Chrome trace uses (add its
  ``baseTimeNanoseconds``), so the two files lie on one timeline;
* a ``record_function`` range of its name while the profiler records;
* on a CUDA device, a pair of CUDA events on the stream current at its
  start, taken from a pool and resolved only when ``device_ms`` is read,
  so nothing synchronises inside the step.

The span stack is per thread. The backward, and with it remat's
recompute, runs on autograd's worker thread on a card: a span opened
there with nothing open on its own thread while ``train.backward`` is
open takes ``train.backward`` as its parent. Finished roots are kept in
memory, the last ``MAX_ROOTS``; ``last_roots`` reads them and
``mean_device_ms`` sums a span's device time a root. Names are dotted
and equal no device kernel's name (a profiler reader that drops device
events named like a host range would lose the kernel).

Spans of the port (``PERF.md`` §3 says which metric reads each):

  train   train.step (root), train.forward, train.backward,
          train.optimizer
  serve   prefill.step (root)
  models  model.head, mamba2.block, mamba2.in_proj, mamba2.conv,
          mamba2.ssd, mamba2.gated_norm, mamba2.out_proj
  kernels kernel.<name> around each forward kernel's dispatch;
          ssd_chunks_backward, flash_carry_backward,
          tile_matmul_backward around the backwards

**The Tracer.** A :class:`Tracer` records complete-duration events
(``ph: "X"``, ``ts``/``dur`` in microseconds — the trace-event spec's
unit) on the same host clock. Span taxonomy of its own events (the
``cat`` field groups them in the viewer):

  serve   tick, prefill, decode, sample, probe (checked ring backends);
          instants link_fault, deadline, nonfinite, degrade, rollback
          (the health monitor)

While ``torch.profiler`` records, its spans also annotate the profiler's
timeline via ``record_function``. Its export adds the program spans of
the roots that started after it was first armed (``cat: "program"``,
each span's ``device_ms`` in ``args``).

Usage::

    tr = Tracer().arm()
    with tr.span("tick", cat="serve", args={"tick": 3}):
        with tr.span("decode", cat="serve"):
            ...
    tr.instant("evict", cat="serve")          # zero-duration marker
    tr.disarm()
    tr.dump(path)                             # {"traceEvents": [...]}

The clock is injectable (``Tracer(clock=...)``, seconds) so golden-file
tests can produce deterministic timestamps.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

import torch

BACKWARD = "train.backward"
MAX_ROOTS = 64

_profiler = torch.autograd.profiler   # its _is_profiler_enabled is the gate
_armed = 0                            # Tracers armed now
_OFF = contextlib.nullcontext()
_EPOCH_NS = time.time_ns() - time.monotonic_ns()   # monotonic -> Unix
_ids = itertools.count(1)
_local = threading.local()
_backward: list = []                  # open train.backward spans
_roots: deque = deque()               # finished roots, oldest first
_pool: list = []                      # free CUDA timing events


def span(name: str):
    """A context around one layer: a recorded ``Span`` while the profiler
    records or a Tracer is armed, else a shared no-op context."""
    if _armed or _profiler._is_profiler_enabled:
        return Span(name)
    return _OFF


def _unix_s() -> float:
    return (time.monotonic_ns() + _EPOCH_NS) * 1e-9


def _thread():
    """This thread's span stack and native id (the profiler's ``tid``;
    asking the system for it costs a call each time)."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class Span:
    """One recorded span (see the module's docstring); a root's ``spans``
    lists every finished span of its call, itself last."""

    __slots__ = ("name", "id", "parent", "root", "recompute", "thread",
                 "start_ns", "end_ns", "spans", "_rf", "_events", "_stream",
                 "_ms")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack, self.thread = _thread()
        parent = stack[-1] if stack else (_backward[-1] if _backward
                                          else None)
        self.id = next(_ids)
        self.parent = parent
        if parent is None:
            self.root, self.recompute, self.spans = self, False, []
        else:
            self.root = parent.root
            self.recompute = parent.recompute or parent.name == BACKWARD
        stack.append(self)
        if self.name == BACKWARD:
            _backward.append(self)
        self._ms = None
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.monotonic_ns()
        self._events = None
        if torch.cuda.is_initialized():
            self._stream = torch.cuda.current_stream()
            self._events = (_event(), _event())
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
            self._stream = None
        self.end_ns = time.monotonic_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _local.stack.pop()
        if self.name == BACKWARD:
            _backward.remove(self)
        self.root.spans.append(self)
        if self.root is self:
            if len(_roots) == MAX_ROOTS:
                _release(_roots.popleft())
            _roots.append(self)
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two CUDA events (waits for the
        second); None off a card."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
            _pool.extend(self._events)
            self._events = None
        return self._ms


def _release(root: Span) -> None:
    """Return a dropped root's unread events to the pool."""
    for s in root.spans:
        if s._events is not None:
            _pool.extend(s._events)
            s._events = None


def last_roots(n: int) -> list:
    """The last ``n`` finished root spans (fewer when fewer are kept),
    oldest first."""
    return list(_roots)[-n:] if n > 0 else []


def mean_device_ms(n: int, root: str, name: str, count: int = 1,
                   recompute: Optional[bool] = None) -> Optional[float]:
    """The device ms of the spans named ``name`` (of that ``recompute``
    flag, when given), summed in each of the last ``n`` roots and averaged
    over them. None when fewer than ``n`` roots are kept, one is not named
    ``root``, one has other than ``count`` such spans, or one such span
    has no device time."""
    roots = last_roots(n)
    if n <= 0 or len(roots) < n or any(r.name != root for r in roots):
        return None
    total = 0.0
    for r in roots:
        got = [s.device_ms for s in r.spans if s.name == name and (
            recompute is None or s.recompute == recompute)]
        if len(got) != count or None in got:
            return None
        total += sum(got)
    return total / n


def _chrome(s: Span, pid: int) -> dict:
    return {"name": s.name, "cat": "program", "ph": "X",
            "ts": (s.start_ns + _EPOCH_NS) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
            "tid": s.thread,
            "args": {"id": s.id, "parent": s.parent.id if s.parent else None,
                     "root": s.root.id, "recompute": s.recompute,
                     "device_ms": s.device_ms}}


class Tracer:
    """Collects trace events in memory; thread-naive by design (the serve
    engine is a single-threaded host). Armed, it switches the program
    spans on."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 pid: int = 1, tid: int = 1, device_annotations: bool = True):
        self._clock = clock or _unix_s
        self.pid = pid
        self.tid = tid
        self.device_annotations = device_annotations
        self.events: list = []
        self._armed = False
        self._since_ns = None     # the program spans' roots it exports

    # ------------------------------------------------------------ helpers
    def _now_us(self) -> float:
        return self._clock() * 1e6

    def _annotation(self, name: str):
        if self.device_annotations and _profiler._is_profiler_enabled:
            return _profiler.record_function(name)
        return None

    # ------------------------------------------------------------ arming
    def arm(self) -> "Tracer":
        """Switch the program spans on until ``disarm``."""
        global _armed
        if not self._armed:
            self._armed = True
            _armed += 1
            if self._since_ns is None:
                self._since_ns = time.monotonic_ns()
        return self

    def disarm(self) -> None:
        global _armed
        if self._armed:
            self._armed = False
            _armed -= 1

    # ------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, cat: str = "repro", args: Optional[dict] = None):
        """A complete-duration event around the block. Nests naturally —
        Perfetto stacks same-tid spans by containment."""
        ann = self._annotation(name)
        if ann is not None:
            ann.__enter__()
        start = self._now_us()
        try:
            yield
        finally:
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": start, "dur": self._now_us() - start,
                "pid": self.pid, "tid": self.tid,
                **({"args": args} if args else {}),
            })
            if ann is not None:
                ann.__exit__(None, None, None)

    def instant(self, name: str, cat: str = "repro",
                args: Optional[dict] = None) -> None:
        """Zero-duration marker."""
        self.events.append({
            "name": name, "cat": cat, "ph": "i",
            "ts": self._now_us(), "s": "t",
            "pid": self.pid, "tid": self.tid,
            **({"args": args} if args else {}),
        })

    # ------------------------------------------------------------ export
    def _program_events(self) -> list:
        """The program spans of the kept roots that started after this
        tracer was first armed, as trace events."""
        if self._since_ns is None:
            return []
        return [_chrome(s, self.pid) for r in list(_roots)
                if r.start_ns >= self._since_ns for s in r.spans]

    def to_chrome(self) -> dict:
        """JSON-object trace format: ts-sorted events plus metadata."""
        return {
            "traceEvents": sorted(self.events + self._program_events(),
                                  key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


class NullTracer(Tracer):
    """Tracing disabled: same surface, records nothing, never touches the
    clock or the profiler, and arms nothing — the default wherever a
    tracer is optional."""

    def __init__(self):
        super().__init__(clock=lambda: 0.0, device_annotations=False)

    @contextmanager
    def span(self, name, cat="repro", args=None):
        yield

    def instant(self, name, cat="repro", args=None):
        pass

    def arm(self):
        return self

    def disarm(self):
        pass
