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
  torus2d     — a :class:`GridSchedule`: per-hop row/col shift pairs that
                sweep an RxC fold row by row
  cannon_grid — torus2d plus Cannon's start skew as ONE grid permutation
                (row r pre-shifted left r), instead of r masked hops

A :class:`GridSchedule` is a sequence of per-hop permutations plus an
optional skew applied before the first consume. Re-pointing queues between
hops is free in the paper's model, so it is as reconfigurable as a fixed
ring. Decode needs a single cycle and falls back to the ring for a grid
(``resolve_safe(cycle_only=True)``), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

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


def cannon_skew(axis: str, rows: int, cols: int, *,
                which: str = "rows") -> Topology:
    """Cannon's start skew as ONE grid permutation. ``rows``: tile (r, c)
    moves left r columns, so PE (r, c) then holds the element of origin
    (r, (c + r) % C), the A-operand skew; ``cols``: tile (r, c) moves up
    c rows, the B-operand skew."""
    if which not in ("rows", "cols"):
        raise ValueError(which)
    perm = []
    for r in range(rows):
        for c in range(cols):
            if which == "rows":
                j = r * cols + (c - r) % cols
            else:
                j = ((r - c) % rows) * cols + c
            perm.append((r * cols + c, j))
    return Topology(f"cannonskew{rows}x{cols}_{which}", axis, rows * cols,
                    tuple(perm))


# ---------------------------------------------------------------------------
# 2-D grid schedules: per-hop permutation sequences
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GridSchedule:
    """A systolic schedule whose permutation may change per hop.

    ``hops[t]`` is the Topology the buffer rides after consume ``t``;
    ``skew`` (optional) is applied once before the first consume (Cannon's
    start offsets); ``row``/``col`` are the constituent shifts. All hops
    share one ring axis."""
    name: str
    axis: str
    rows: int
    cols: int
    hops: tuple[Topology, ...]
    skew: Optional[Topology] = None
    row: Optional[Topology] = None
    col: Optional[Topology] = None

    @property
    def size(self) -> int:
        return self.rows * self.cols


AnySchedule = Union[Topology, GridSchedule]


def _grid_hops(axis: str, rows: int, cols: int) -> tuple[Topology, ...]:
    """The torus2d hop order: sweep each row, then step down. Row phases
    alternate direction, so with an even row count the row hops cancel and
    the R down-hops close the cycle: buffers return home after R*C hops."""
    right = torus_shift(axis, rows, cols, direction="right")
    left = torus_shift(axis, rows, cols, direction="left")
    down = torus_shift(axis, rows, cols, direction="down")
    hops: list[Topology] = []
    for r in range(rows):
        hops += [right if r % 2 == 0 else left] * (cols - 1)
        hops.append(down)
    return tuple(hops)


def torus2d(axis: str, rows: int, cols: int) -> GridSchedule:
    """Cannon-style 2-D ring order on an RxC fold: row and column shifts."""
    return GridSchedule(
        name=f"torus2d{rows}x{cols}", axis=axis, rows=rows, cols=cols,
        hops=_grid_hops(axis, rows, cols),
        row=torus_shift(axis, rows, cols, direction="right"),
        col=torus_shift(axis, rows, cols, direction="down"))


def cannon_grid(axis: str, rows: int, cols: int) -> GridSchedule:
    """torus2d with Cannon's skewed start: row r begins its sweep shifted
    by r, so the arrival order differs per row while every PE still sees
    every shard exactly once."""
    base = torus2d(axis, rows, cols)
    return GridSchedule(
        name=f"cannon{rows}x{cols}", axis=axis, rows=rows, cols=cols,
        hops=base.hops, skew=cannon_skew(axis, rows, cols, which="rows"),
        row=base.row, col=base.col)


# ---------------------------------------------------------------------------
# schedule algebra: tables the ring kernels consume
# ---------------------------------------------------------------------------


def hop_topos(sched: AnySchedule):
    """The per-hop Topology sequence of a schedule: a grid's own hops, or
    a plain Topology repeated ``size`` times."""
    if isinstance(sched, GridSchedule):
        return list(sched.hops)
    return [sched] * sched.size


def _perm_array(topo: Topology) -> np.ndarray:
    """dst[i] = where node i's element goes; identity off the perm."""
    dst = np.arange(topo.size)
    for s, d in topo.perm:
        dst[s] = d
    return dst


def source_table(sched: AnySchedule) -> np.ndarray:
    """[n, n] int32 table: entry (d, t) = origin shard of the buffer PE d
    holds at consume t (after the skew, if any, and t hops)."""
    n = sched.size
    topos = hop_topos(sched)
    origin = np.arange(n)
    if isinstance(sched, GridSchedule) and sched.skew is not None:
        moved = np.empty(n, np.int64)
        moved[_perm_array(sched.skew)] = origin  # receiver holds sender's
        origin = moved
    table = np.zeros((n, n), np.int32)
    table[:, 0] = origin
    for t in range(1, n):
        dst = _perm_array(topos[t - 1])
        table[dst, t] = table[np.arange(n), t - 1]
    return table


def dest_table(sched: AnySchedule) -> np.ndarray:
    """[n, n] int32 table for reduce-scatter rings: entry (d, t) = the PE
    where an accumulator that is on PE d at step t finally lands after
    riding hops t..n-2 (step n-1 is the last compute; no hop follows it).
    For the +1 ring this is (d + n - 1 - t) mod n; a grid rides its hop
    sequence (the skew plays no part: reduce-scatter needs no offsets)."""
    n = sched.size
    topos = hop_topos(sched)
    table = np.zeros((n, n), np.int32)
    table[:, n - 1] = np.arange(n)
    for t in range(n - 2, -1, -1):
        dst = _perm_array(topos[t])
        table[:, t] = table[dst, t + 1]
    return table


def is_cycle(sched: AnySchedule) -> bool:
    """True iff ``sched`` is a plain Topology forming one full n-cycle
    (never a GridSchedule): the shape decode's ``stream_carry`` needs."""
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
    """A 2-D fold needs >= 2 real rows and an even row count (so torus2d's
    alternating sweep closes the cycle)."""
    rows, _ = default_fold(size)
    return rows >= 2 and rows % 2 == 0


def resolve(name: str, axis: str, size: int) -> AnySchedule:
    """Topology name -> schedule: ``ring`` | ``snake_fold`` | ``torus2d`` |
    ``cannon_grid``, optionally suffixed ``:RxC`` to pin the fold
    (default: near-square)."""
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
    if base == "torus2d":
        return torus2d(axis, rows, cols)
    if base == "cannon_grid":
        return cannon_grid(axis, rows, cols)
    raise ValueError(f"unknown topology name: {name!r}")


def resolve_safe(name: str, axis: str, size: int, *,
                 cycle_only: bool = False) -> AnySchedule:
    """:func:`resolve` with the reference's fallback to the +1 ring where
    the named schedule does not apply: an unknown name, a grid fold that
    does not close (``grid_ok``), or a cycle-only caller (decode) handed a
    grid schedule."""
    if not name or name == "ring":
        return ring(axis, size)
    base = name.partition(":")[0]
    if base in GRID_SCHEDULES and not grid_ok(size):
        return ring(axis, size)
    try:
        sched = resolve(name, axis, size)
    except ValueError:
        return ring(axis, size)
    if cycle_only and not is_cycle(sched):
        return ring(axis, size)
    return sched
