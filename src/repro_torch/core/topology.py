"""Systolic topologies over the emulated PE ring (numpy only).

A topology is a permutation over the PEs of one ring axis: ``perm`` lists
(source, destination) links. On one card the ring is a leading tensor
dimension, and a hop gathers along it (``core/queues.hop``); building a
different Topology object *is* the paper's runtime queue re-pointing.

The schedules the ring ops need:

  ring        — circular stream (collective matmuls, ring attention, halos)
  snake_fold  — one cycle in boustrophedon order over an RxC fold
  chains      — k open chains with no wrap-around (pipelines: the heads
                pop zeros, ``core/queues.hop``)
  torus_shift — a 1-D PE axis folded into an RxC grid, every PE shifting
                one step along a row or column (Cannon)

2-D grid schedules (torus2d, cannon_grid) are not ported yet; decode, which
needs a single cycle, falls back to the ring for them as the reference
does, and every other caller raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GRID_SCHEDULES = ("torus2d", "cannon_grid")


@dataclass(frozen=True)
class Topology:
    name: str
    axis: str
    size: int
    perm: tuple[tuple[int, int], ...]


def ring(axis: str, size: int, step: int = 1) -> Topology:
    perm = tuple((i, (i + step) % size) for i in range(size))
    return Topology(f"ring{step:+d}", axis, size, perm)


def chains(axis: str, size: int, n_chains: int = 1) -> Topology:
    """k independent open chains; element 0 of each chain is the head
    (mover PE). No wrap-around link."""
    if size % n_chains:
        raise ValueError(f"{n_chains} chains do not divide {size} PEs")
    length = size // n_chains
    perm = []
    for c in range(n_chains):
        base = c * length
        for i in range(length - 1):
            perm.append((base + i, base + i + 1))
    return Topology(f"chains{n_chains}", axis, size, tuple(perm))


def torus_shift(axis: str, rows: int, cols: int, *,
                direction: str) -> Topology:
    """Fold a 1-D PE axis into an RxC grid; shift right/left/down/up."""
    step = {"right": (0, 1), "left": (0, -1), "down": (1, 0),
            "up": (-1, 0)}
    if direction not in step:
        raise ValueError(direction)
    dr, dc = step[direction]
    perm = tuple((r * cols + c, ((r + dr) % rows) * cols + (c + dc) % cols)
                 for r in range(rows) for c in range(cols))
    return Topology(f"torus{rows}x{cols}_{direction}", axis, rows * cols,
                    perm)


def snake_ring(axis: str, rows: int, cols: int) -> Topology:
    """Single ring visiting all RxC PEs in boustrophedon (snake) order:
    consecutive hops are row-neighbors except at row turns."""
    size = rows * cols
    order = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order += [r * cols + c for c in cs]
    perm = tuple((order[i], order[(i + 1) % size]) for i in range(size))
    return Topology(f"snake{rows}x{cols}", axis, size, perm)


def snake_fold(axis: str, rows: int, cols: int) -> Topology:
    """The snake_ring cycle under its autotuner-facing name."""
    base = snake_ring(axis, rows, cols)
    return Topology(f"snakefold{rows}x{cols}", axis, base.size, base.perm)


# ---------------------------------------------------------------------------
# schedule algebra: tables the ring kernels consume
# ---------------------------------------------------------------------------


def hop_topos(sched: Topology):
    """The per-hop Topology sequence of a schedule: constant for a plain
    Topology (2-D grid schedules, not ported yet, vary it per hop)."""
    return [sched] * sched.size


def _perm_array(topo: Topology) -> np.ndarray:
    """dst[i] = where node i's element goes; identity off the perm."""
    dst = np.arange(topo.size)
    for s, d in topo.perm:
        dst[s] = d
    return dst


def source_table(sched: Topology) -> np.ndarray:
    """[n, n] int32 table: entry (d, t) = origin shard of the buffer PE d
    holds at consume t (after t hops)."""
    n = sched.size
    topos = hop_topos(sched)
    table = np.zeros((n, n), np.int32)
    table[:, 0] = np.arange(n)
    for t in range(1, n):
        dst = _perm_array(topos[t - 1])
        table[dst, t] = table[np.arange(n), t - 1]
    return table


def dest_table(sched: Topology) -> np.ndarray:
    """[n, n] int32 table for reduce-scatter rings: entry (d, t) = the PE
    where an accumulator that is on PE d at step t finally lands after
    riding hops t..n-2 (step n-1 is the last compute; no hop follows it).
    For the +1 ring this is (d + n - 1 - t) mod n."""
    n = sched.size
    topos = hop_topos(sched)
    table = np.zeros((n, n), np.int32)
    table[:, n - 1] = np.arange(n)
    for t in range(n - 2, -1, -1):
        dst = _perm_array(topos[t])
        table[:, t] = table[dst, t + 1]
    return table


def is_cycle(sched) -> bool:
    """True iff ``sched`` is a Topology forming one full n-cycle."""
    if not isinstance(sched, Topology):
        return False
    nxt = dict(sched.perm)
    if len(nxt) != sched.size or set(nxt.values()) != set(range(sched.size)):
        return False
    seen, cur = 0, 0
    for _ in range(sched.size):
        cur = nxt[cur]
        seen += 1
        if cur == 0:
            break
    return cur == 0 and seen == sched.size


# ---------------------------------------------------------------------------
# name -> schedule resolution
# ---------------------------------------------------------------------------


def default_fold(size: int) -> tuple[int, int]:
    """Near-square RxC fold: the largest divisor pair with rows <= cols
    (8 -> 2x4, 16 -> 4x4, 12 -> 3x4; primes fold 1xN)."""
    rows = 1
    r = 2
    while r * r <= size:
        if size % r == 0:
            rows = r
        r += 1
    return rows, size // rows


def grid_ok(size: int) -> bool:
    """A 2-D fold needs >= 2 real rows and an even row count."""
    rows, _ = default_fold(size)
    return rows >= 2 and rows % 2 == 0


def resolve(name: str, axis: str, size: int) -> Topology:
    """Topology name -> schedule: ``ring`` | ``snake_fold``, optionally
    suffixed ``:RxC`` to pin the fold (default: near-square)."""
    base, _, fold = name.partition(":")
    if fold:
        rows, cols = (int(v) for v in fold.split("x"))
        if rows * cols != size:
            raise ValueError(f"fold {fold} does not cover {size} PEs")
    else:
        rows, cols = default_fold(size)
    if base == "ring":
        return ring(axis, size)
    if base == "snake_fold":
        return snake_fold(axis, rows, cols)
    if base in GRID_SCHEDULES:
        raise NotImplementedError(
            f"2-D grid schedule {base!r} is not ported yet")
    raise ValueError(f"unknown topology name: {name!r}")


def resolve_safe(name: str, axis: str, size: int, *,
                 cycle_only: bool = False) -> Topology:
    """:func:`resolve` with the reference's fallback to the +1 ring where
    the named schedule does not apply: an unknown name, a degenerate grid
    fold, or a cycle-only caller (decode) handed a grid schedule. A grid
    schedule that would apply raises, since it is not ported yet."""
    if not name or name == "ring":
        return ring(axis, size)
    base = name.partition(":")[0]
    if base in GRID_SCHEDULES and (cycle_only or not grid_ok(size)):
        return ring(axis, size)
    try:
        sched = resolve(name, axis, size)
    except ValueError:
        return ring(axis, size)
    if cycle_only and not is_cycle(sched):
        return ring(axis, size)
    return sched
