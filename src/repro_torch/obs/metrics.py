"""Metrics registry: counters / gauges / histograms, exportable as JSON
and Prometheus text exposition (DESIGN.md §8).

Pure Python + stdlib on purpose — the serve scheduler is numpy-only and
must stay importable without torch, and metric updates sit on the engine's
host hot path where a device round-trip per counter bump would swamp the
thing being measured.

Instrument names follow Prometheus conventions, with units in the name:

  counters    repro_tokens_total, repro_ticks_total, repro_rollbacks_total,
              repro_degradations_total, repro_evictions_total,
              repro_link_tag_errors_total, repro_link_csum_errors_total, ...
  gauges      repro_active_slots, repro_queue_depth, repro_mode_rung, ...
  histograms  repro_tick_latency_seconds, repro_prefill_latency_seconds
              (p50/p90/p99 via reservoir quantiles)

Usage::

    reg = Registry()
    reg.counter("repro_tokens_total").inc(8)
    with reg.histogram("repro_tick_latency_seconds").time():
        engine.step()
    reg.to_json()          # snapshot dict
    reg.to_prometheus()    # text exposition

Snapshots are mergeable (``Registry.merge``): counters add, gauges take
the other's latest value, histograms pool their samples — so per-phase or
per-process snapshots can be combined into one report.
"""
from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from typing import Dict, Optional


class Counter:
    """Monotonically increasing count."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: float = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {by}")
        self.value += by


class Gauge:
    """Point-in-time value (can go up and down)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, by: float = 1.0) -> None:
        self.value += by

    def dec(self, by: float = 1.0) -> None:
        self.value -= by


class Histogram:
    """Sample distribution with exact-ish quantiles from a bounded
    reservoir (simple windowed reservoir: keeps the most recent
    ``max_samples`` observations — tick latencies drift with load, so
    recency beats uniform reservoir sampling here), plus exact count/sum
    over all observations for rate math."""

    def __init__(self, name: str, help: str = "", max_samples: int = 4096):
        self.name = name
        self.help = help
        self.max_samples = max_samples
        self.count: int = 0
        self.sum: float = 0.0
        self._samples: list = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._samples.append(v)
        if len(self._samples) > self.max_samples:
            del self._samples[: len(self._samples) - self.max_samples]

    @contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the retained window; NaN when
        empty (Prometheus renders NaN for unobserved quantiles too)."""
        if not self._samples:
            return math.nan
        s = sorted(self._samples)
        if len(s) == 1:
            return s[0]
        pos = q * (len(s) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class Registry:
    """Named instrument store. get-or-create accessors; name collisions
    across instrument kinds are errors."""

    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- access
    def _check_free(self, name: str, kind: dict) -> None:
        for d in (self._counters, self._gauges, self._histograms):
            if d is not kind and name in d:
                raise ValueError(f"metric {name!r} already registered "
                                 "as a different instrument kind")

    def counter(self, name: str, help: str = "") -> Counter:
        if name not in self._counters:
            self._check_free(name, self._counters)
            self._counters[name] = Counter(name, help)
        return self._counters[name]

    def gauge(self, name: str, help: str = "") -> Gauge:
        if name not in self._gauges:
            self._check_free(name, self._gauges)
            self._gauges[name] = Gauge(name, help)
        return self._gauges[name]

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 4096) -> Histogram:
        if name not in self._histograms:
            self._check_free(name, self._histograms)
            self._histograms[name] = Histogram(name, help, max_samples)
        return self._histograms[name]

    # ------------------------------------------------------------ export
    def to_json(self) -> dict:
        """Snapshot as a plain dict (stable layout, json-serializable)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for n, c in sorted(self._counters.items()):
            out["counters"][n] = c.value
        for n, g in sorted(self._gauges.items()):
            out["gauges"][n] = g.value
        for n, h in sorted(self._histograms.items()):
            out["histograms"][n] = {
                "count": h.count,
                "sum": h.sum,
                "quantiles": {str(q): h.quantile(q) for q in self.QUANTILES},
            }
        return out

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4. Histograms export as
        summaries (quantile labels) — the natural fit for reservoir
        quantiles."""
        lines = []
        for n, c in sorted(self._counters.items()):
            if c.help:
                lines.append(f"# HELP {n} {c.help}")
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_fmt(c.value)}")
        for n, g in sorted(self._gauges.items()):
            if g.help:
                lines.append(f"# HELP {n} {g.help}")
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_fmt(g.value)}")
        for n, h in sorted(self._histograms.items()):
            if h.help:
                lines.append(f"# HELP {n} {h.help}")
            lines.append(f"# TYPE {n} summary")
            for q in self.QUANTILES:
                lines.append(
                    f'{n}{{quantile="{q}"}} {_fmt(h.quantile(q))}')
            lines.append(f"{n}_sum {_fmt(h.sum)}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"

    def dump_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    # ------------------------------------------------------------- merge
    def merge(self, other: "Registry") -> "Registry":
        """Fold another registry into this one: counters add, gauges take
        ``other``'s value, histograms pool retained samples and exact
        count/sum. Returns self."""
        for n, c in other._counters.items():
            self.counter(n, c.help).value += c.value
        for n, g in other._gauges.items():
            self.gauge(n, g.help).set(g.value)
        for n, h in other._histograms.items():
            mine = self.histogram(n, h.help, h.max_samples)
            mine.count += h.count
            mine.sum += h.sum
            mine._samples.extend(h._samples)
            if len(mine._samples) > mine.max_samples:
                del mine._samples[: len(mine._samples) - mine.max_samples]
        return self


_DEFAULT: Optional[Registry] = None


def default() -> Registry:
    """Process-wide registry (created on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry()
    return _DEFAULT


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
