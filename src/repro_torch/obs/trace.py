"""Host-side tracing: engine-tick phases as Chrome trace-event JSON,
viewable in Perfetto / chrome://tracing.

Span taxonomy (the ``cat`` field groups them in the viewer):

  serve   tick, prefill, decode, sample, probe (checked ring backends);
          instants link_fault, deadline, nonfinite, degrade, rollback
          (the health monitor)

A :class:`Tracer` records complete-duration events (``ph: "X"``, ``ts``/
``dur`` in microseconds — the trace-event spec's unit) on the host clock.
When ``torch.profiler`` is recording, spans also annotate its timeline via
``torch.profiler.record_function`` (imported lazily, so the scheduler may
trace without torch).

Usage::

    tr = Tracer()
    with tr.span("tick", cat="serve", args={"tick": 3}):
        with tr.span("decode", cat="serve"):
            ...
    tr.instant("evict", cat="serve")          # zero-duration marker
    tr.dump(path)                             # {"traceEvents": [...]}

The clock is injectable (``Tracer(clock=...)``) so golden-file tests can
produce deterministic timestamps.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Optional


class Tracer:
    """Collects trace events in memory; thread-naive by design (the serve
    engine is a single-threaded host)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 pid: int = 1, tid: int = 1, device_annotations: bool = True):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self.pid = pid
        self.tid = tid
        self.device_annotations = device_annotations
        self.events: list = []

    # ------------------------------------------------------------ helpers
    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _annotation(self, name: str):
        if not self.device_annotations:
            return None
        try:
            from torch.profiler import record_function
        except ImportError:
            return None
        return record_function(name)

    # ------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, cat: str = "repro", args: Optional[dict] = None):
        """A complete-duration event around the block. Nests naturally —
        Perfetto stacks same-tid spans by containment."""
        start = self._now_us()
        ann = self._annotation(name)
        if ann is not None:
            ann.__enter__()
        try:
            yield
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": start, "dur": self._now_us() - start,
                "pid": self.pid, "tid": self.tid,
                **({"args": args} if args else {}),
            })

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
    def to_chrome(self) -> dict:
        """JSON-object trace format: ts-sorted events plus metadata."""
        return {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


class NullTracer(Tracer):
    """Tracing disabled: same surface, records nothing, never touches the
    clock or the profiler — the default wherever a tracer is optional."""

    def __init__(self):
        super().__init__(clock=lambda: 0.0, device_annotations=False)

    @contextmanager
    def span(self, name, cat="repro", args=None):
        yield

    def instant(self, name, cat="repro", args=None):
        pass
