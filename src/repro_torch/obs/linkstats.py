"""Link telemetry: queue-traffic counters recorded by the systolic
primitives, the port of the reference's ``repro/obs/linkstats.py``.

The paper's headline numbers (per-PE compute-unit utilization, queue
traffic per link mode, GOPS/W) are measurements of queue traffic.
:class:`LinkStats` is the software analogue of MemPool's per-PE
performance counters, summed over the PEs of the ring:

  pushes / pops     queue operations: one per leaf per PE per hop (the
                    paper's several-queues-per-PE layout: each operand
                    class is its own FIFO).
  payload_bytes     bytes pushed onto the links (payload only; the
                    checked-link sidecar is control traffic and excluded).
  mcast_bytes       bytes read through the shared-memory multicast (the
                    all-gather baseline's concurrent loads).
  tag_errors        checked-link sender-id / sequence failures (stuck or
                    late links) summed over hops.
  csum_errors       checked-link payload-checksum failures (corruption,
                    drops) summed over hops.
  faulty_hops       (PE, hop) pairs at which any sidecar check tripped.

Every PE-local tensor of the port carries the PE dimension first, so one
record covers every PE: per PE a leaf moves its bytes over the PE
dimension's size, summed over PEs the whole tensor's bytes. The counts are
the totals the reference's ``device_sum`` gives over its per-device
counters. Nothing here crosses a ``shard_map`` or a ``lax.scan``, so the
reference's helpers that carry counters out of them (``stats_specs``,
``expand``, ``device_sum``, ``instrumented``, ``absorb``, ``shard_call``,
``scan``) have no counterpart: a Python loop over layers or hops records
straight into the active scope.

Mechanics, as in the reference:

* ``with linkstats.collect(enabled):`` arms a :class:`StatsScope`; the queue
  primitives record into the innermost one. With no scope armed nothing is
  recorded and no work is added.
* ``enabled`` is a host 0/1 (the reference passes it as a jit argument):
  a disabled scope records nothing.
* ``with linkstats.mute():`` hides any outer scope; the stream drivers mute
  their hop loop and record the whole circuit once afterwards.

Push, pop and byte counts are host integers. The reference keeps its byte
counters in float32, which stops being exact above 2**24 bytes; the port
keeps them as exact integers. Only the checked-link error counts are
device tensors (sums of the hops' health flags); they are read on the host
only by :meth:`LinkStats.as_dict`.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, fields
from typing import Any

FIELDS = ("pushes", "pops", "payload_bytes", "mcast_bytes", "tag_errors",
          "csum_errors", "faulty_hops")


@dataclass
class LinkStats:
    """Queue-traffic counters summed over the PEs. Traffic counts are ints;
    the error counts are ints or 0-d device tensors."""
    pushes: int = 0
    pops: int = 0
    payload_bytes: int = 0
    mcast_bytes: int = 0
    tag_errors: Any = 0
    csum_errors: Any = 0
    faulty_hops: Any = 0

    def add(self, other: "LinkStats") -> "LinkStats":
        return LinkStats(*(getattr(self, f.name) + getattr(other, f.name)
                           for f in fields(self)))

    def as_dict(self) -> dict:
        """Host-side plain ints (reads the error tensors off the device)."""
        return {f: int(getattr(self, f)) for f in FIELDS}


def zeros() -> LinkStats:
    return LinkStats()


def make(**kw) -> LinkStats:
    """Build a delta; unset fields are 0."""
    return LinkStats(**kw)


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

_SCOPE: list = []          # StatsScope entries, or None for a mute frame


class StatsScope:
    """Accumulates LinkStats while armed; a disabled scope records
    nothing."""

    def __init__(self, enabled=1):
        self.enabled = bool(enabled)
        self.stats = zeros()

    def record(self, delta: LinkStats) -> None:
        if self.enabled:
            self.stats = self.stats.add(delta)


@contextmanager
def collect(enabled=1):
    """Arm telemetry for the extent of the block (innermost scope wins)."""
    sc = StatsScope(enabled)
    _SCOPE.append(sc)
    try:
        yield sc
    finally:
        _SCOPE.pop()


@contextmanager
def mute():
    """Hide any outer scope (the stream drivers' hop loops)."""
    _SCOPE.append(None)
    try:
        yield
    finally:
        _SCOPE.pop()


def active() -> StatsScope | None:
    return _SCOPE[-1] if _SCOPE else None


def armed() -> bool:
    """True when a scope is collecting."""
    return active() is not None


# ---------------------------------------------------------------------------
# recording helpers (called by the queue primitives)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _recording() -> StatsScope | None:
    sc = active()
    return sc if sc is not None and sc.enabled else None


def payload_static(tree) -> tuple[int, int, int]:
    """(queues, PEs, bytes over all PEs) of one hop's element: its leaves,
    the size of their leading PE dimension, and their bytes."""
    leaves = _leaves(tree)
    return (len(leaves), leaves[0].shape[0],
            sum(leaf.numel() * leaf.element_size() for leaf in leaves))


def record_hops(tree, n_hops: int = 1, health=None) -> None:
    """Record ``n_hops`` hops of ``tree``'s queue set (every PE) into the
    active scope, if any. ``health`` is an int32 ``[..., 2]`` stack of
    per-(PE, hop) (tag_err, csum_err) flags from checked links; without
    it the error counters stay untouched."""
    sc = _recording()
    if sc is None:
        return
    n_q, n_pe, nbytes = payload_static(tree)
    delta = make(pushes=n_hops * n_q * n_pe, pops=n_hops * n_q * n_pe,
                 payload_bytes=n_hops * nbytes)
    if health is not None:
        h = health.reshape(-1, 2)
        delta.tag_errors = h[:, 0].sum()
        delta.csum_errors = h[:, 1].sum()
        delta.faulty_hops = (h.sum(dim=1) > 0).sum()
    sc.record(delta)


def record_multicast(tree, fan_in: int = 1) -> None:
    """Record a shared-memory multicast read: every PE loaded its share of
    ``tree`` from ``fan_in`` peers (all-gather output = fan_in x local)."""
    sc = _recording()
    if sc is None:
        return
    sc.record(make(mcast_bytes=fan_in * payload_static(tree)[2]))
