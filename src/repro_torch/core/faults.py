"""Deterministic fault injection for the systolic queue links.

The queues are the flexibility *and* the failure surface of the paper's
shared-memory systolic model: a single stale, misrouted, or corrupted pop
silently poisons every downstream PE. This module makes those failures a
reproducible input, so every ring schedule (attention, decode, collective
matmul, halo) can be exercised under faults. It mirrors the reference's
``repro/core/faults.py``.

Fault classes (one per way a memory-mapped FIFO goes wrong):

  corrupt — the popped payload is garbage: float leaves become NaN, int
            leaves get a seeded bit-flip, bool leaves are negated.
  drop    — the popped payload is zeros (the link dropped the message).
  stale   — the link is *stuck* from hop ``t`` on: every later pop returns
            the element the PE already holds. Persistent.
  slow    — a one-hop hiccup: at hop ``t`` the pop returns the previous
            element, then the link recovers. Transient. (Wall-clock
            slowness is the serve layer's deadline monitor's job,
            ``serve/health.py``.)

A :class:`FaultSpec` names the kind, the hop index ``t`` and the PE whose
pop is faulted: its index along the PE dimension (the leading tensor
dimension of every queue element, ``core/queues.py``).

Two layers, as in the reference:

* **Host registry** — ``with faults.inject(spec):`` arms a process-global
  spec; backends read it back with :func:`injected_vec`.
* **Scope** — ``with faults.scope(vec):`` publishes an encoded spec to the
  queue hops below it; ``queues.hop`` applies it. Without a scope a hop
  falls back to the host registry.

The reference passes the encoded spec into its jitted step as an array, so
arming never retraces. The port runs eagerly and ``t`` is a host int, so
:func:`apply` decides on the host whether a hop is hit: an unarmed hop, or
one the spec does not target, adds no device work; a hit hop replaces one
PE's row of the popped element.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

KINDS = ("none", "corrupt", "drop", "stale", "slow")
_KIND_ID = {k: i for i, k in enumerate(KINDS)}


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic queue-link fault.

    kind:   one of :data:`KINDS` (not "none").
    hop:    hop index ``t`` within a stream at which the fault fires
            (for "stale", the first of the stuck hops).
    device: index along the PE dimension of the PE whose *pop* is faulted.
    seed:   drives the bit-flip pattern for int-leaf corruption.
    """
    kind: str
    hop: int = 0
    device: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS or self.kind == "none":
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def encode(self) -> tuple[int, int, int, int]:
        """(kind_id, hop, device, seed): the reference's int32[4] layout,
        kept on the host."""
        return (_KIND_ID[self.kind], self.hop, self.device, self.seed)


def no_fault_vec() -> tuple[int, int, int, int]:
    """The disarmed spec: every hop passes it through untouched."""
    return (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# host registry (process-global, read at call time by backends)
# ---------------------------------------------------------------------------

_INJECTED: list[FaultSpec] = []


@contextmanager
def inject(spec: FaultSpec):
    """Arm ``spec`` for the dynamic extent of the block."""
    _INJECTED.append(spec)
    try:
        yield spec
    finally:
        _INJECTED.pop()


def injected() -> FaultSpec | None:
    return _INJECTED[-1] if _INJECTED else None


def injected_vec() -> tuple[int, int, int, int]:
    """Encoded armed spec, or the disarmed vector."""
    spec = injected()
    return spec.encode() if spec is not None else no_fault_vec()


# ---------------------------------------------------------------------------
# scope (publishes an encoded spec to the queue hops below it)
# ---------------------------------------------------------------------------

_SCOPE: list = []


@contextmanager
def scope(vec):
    """Publish an encoded spec to the queue primitives for the extent of
    the block."""
    _SCOPE.append(tuple(int(v) for v in vec))
    try:
        yield
    finally:
        _SCOPE.pop()


def active_vec():
    """The spec visible to queue hops here: the innermost :func:`scope`,
    else a host-armed :func:`inject` spec, else None (no fault machinery
    at all)."""
    if _SCOPE:
        return _SCOPE[-1]
    spec = injected()
    return spec.encode() if spec is not None else None


# ---------------------------------------------------------------------------
# application (called by queues.hop with host values)
# ---------------------------------------------------------------------------


def _poison_leaf(leaf: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic garbage of the leaf's dtype: NaN for floats, ``not``
    for bools, ``leaf ^ (0x5A5A5A5A ^ seed)`` for ints (the flip word is
    formed in int32, then cast to the leaf's type, as the reference does)."""
    if leaf.is_floating_point():
        return torch.full_like(leaf, float("nan"))
    if leaf.dtype == torch.bool:
        return torch.logical_not(leaf)
    flip = (0x5A5A5A5A ^ seed) & 0xFFFFFFFF
    flip = flip - (1 << 32) if flip >= (1 << 31) else flip
    return leaf ^ torch.tensor(flip, dtype=torch.int32).to(leaf.dtype)


def _map(fn, a, b):
    if isinstance(a, tuple):
        return tuple(_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _replace_row(moved: torch.Tensor, prev: torch.Tensor, device: int,
                 bad) -> torch.Tensor:
    """``moved`` with PE ``device``'s row replaced by ``bad(moved, prev)``
    (a PE index past the ring hits nothing)."""
    if device >= moved.shape[0]:
        return moved
    out = moved.clone()
    out[device] = bad(moved[device], prev[device])
    return out


def apply(vec, moved, prev, t, data_only: bool = False,
          stall_only: bool = False):
    """Apply the encoded fault to one hop's result.

    moved: the post-hop element (a tensor or a tuple of them, PE dimension
           first): what a clean pop returns.
    prev:  the receiving PEs' pre-hop element (what a stuck or late pop
           returns instead).
    t:     the hop index (a host int; None: the hop cannot be targeted).

    data_only:  apply only payload faults (corrupt/drop) — checked links,
                where the sidecar models a separate narrow control FIFO
                that data-word faults cannot touch.
    stall_only: apply only whole-message faults (stale/slow) — a stuck
                link freezes payload *and* sidecar together.
    """
    kind_id, hop_t, device, seed = vec
    if t is None or kind_id == 0:
        return moved
    kind = KINDS[kind_id]
    if kind in ("corrupt", "drop"):
        if stall_only or t != hop_t:
            return moved
        bad = (lambda m, p: _poison_leaf(m, seed)) if kind == "corrupt" \
            else (lambda m, p: torch.zeros_like(m))
    else:
        hit = t >= hop_t if kind == "stale" else t == hop_t
        if data_only or not hit:
            return moved
        bad = lambda m, p: p                                  # noqa: E731
    return _map(lambda m, p: _replace_row(m, p, device, bad), moved, prev)
