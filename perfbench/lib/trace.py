"""Reading a ``torch.profiler`` trace of the traced calls.

The traced window runs from the start of the first ``perfbench.call``
range to the end of the last one (host ranges; each call ends in a
synchronisation, so its kernels lie inside it). Device kernels are
clipped to the window. Busy time is the length of the union of their
intervals (one stream runs them one after another, but the union holds
for overlap too); the idle share is what is left of the window. Each idle
gap is put down to what the host was doing at its middle: the innermost
host range open then (an aten op, a runtime call such as
``cudaLaunchKernel``, or a ``record_function`` range), or "host Python"
when only the call's own range was open.

The aggregation by kernel name follows ``chip_smoke.py``'s profiler
helpers (``_kernel_rows``: device events, user annotations left out).
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

CALL = "perfbench.call"
HOST_PYTHON = "host Python"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    calls: int = 0
    kernel_s: dict = field(default_factory=dict)   # name -> seconds
    kernel_n: dict = field(default_factory=dict)   # name -> launches seen
    gaps_s: dict = field(default_factory=dict)     # host activity -> seconds

    def top(self, table: dict, k: int = 10):
        """The ``k`` largest entries, [[short name, seconds]]."""
        return [[short(name), table[name]] for name in
                sorted(table, key=lambda n: -table[n])[:k]]


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, namespaces and argument
    list, cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "c10::"):
        name = name.replace(noise, "")
    if name.endswith(")") and "(" in name and not name.startswith("("):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def profiler():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def read(events) -> Trace:
    """A ``Trace`` of a profiler's ``events()``."""
    calls, host, device = [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if _is_device(e):
            if not getattr(e, "is_user_annotation", False):
                device.append((start, end, e.name))
        elif e.name == CALL:
            calls.append((start, end))
        elif end > start:
            host.append((start, end, e.name))
    # a record_function range is mirrored on the device's timeline under
    # its host name; no kernel bears the name of a host range
    labels = {name for _, _, name in host} | {CALL}
    kernels = [k for k in device if k[2] not in labels]
    out = Trace(calls=len(calls))
    if not calls:
        return out
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    out.window_s = (hi - lo) / 1e6
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    spans = []
    for start, end, name in kernels:
        a, b = max(start, lo), min(end, hi)
        if b <= a:
            continue
        kernel_s[name] += (b - a) / 1e6
        kernel_n[name] += 1
        spans.append((a, b))
    out.kernel_s, out.kernel_n = dict(kernel_s), dict(kernel_n)
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_s = sum(b - a for a, b in merged) / 1e6
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out.gaps_s = _attribute(gaps, host)
    return out


def _attribute(gaps, host) -> dict:
    """Seconds of idle gaps by the innermost host range open at each gap's
    middle (the open range that started last)."""
    host = sorted(host)
    totals = defaultdict(float)
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else HOST_PYTHON
        totals[label] += (b - a) / 1e6
    return dict(totals)
