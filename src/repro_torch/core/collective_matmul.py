"""Systolic (ring) collective matmuls on the emulated PE ring.

The streamed operand rides the ring (``queues.stream``) while the resident
operand, a weight slice per PE, stays put; each PE accumulates its output
tile in place (output-stationary), as in the reference
``repro/core/collective_matmul.py``. PE-local tensors carry a leading PE
dimension ``[n, ...]``; the ``systolic_*`` wrappers take and return the
global tensors and do the split that ``shard_map`` does in the reference.

Link modes: sw / xqueue / qlr (core/queues.py), plus ``baseline``: one
all-gather and one local product (the pure shared-memory model).

The AG and RS rings run on any full-coverage schedule: a single-cycle
Topology or a 2-D ``GridSchedule`` (torus2d, cannon_grid), whose per-hop
permutations the source and dest tables follow.

``cannon_matmul`` is the 2-D output-stationary form (the paper's matmul
kernel): a square grid folded from the PE axis, A tiles streaming left
along the rows and B tiles up along the columns.

Telemetry (``obs/linkstats.py``) counts what the reference counts: the
baseline's all-gathers and reduce-scatter as multicast loads, every hop as
queue traffic, the masked skew as its n-1 hops per operand, the grid skew
as one. Hops carry the reference's sequence numbers, so a fault spec
reaches the same hops.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import queues
from repro_torch.core import topology as topo_lib
from repro_torch.core.queues import table_cache
from repro_torch.core.topology import (
    Topology,
    cannon_skew,
    ring,
    torus_shift,
)
from repro_torch.kernels.systolic_matmul.ops import tile_matmul
from repro_torch.obs import linkstats


def _full_coverage(topo) -> None:
    """A plain Topology must be a single full cycle (a GridSchedule covers
    every shard by construction), as the reference asserts."""
    if isinstance(topo, Topology) and not topo_lib.is_cycle(topo):
        raise ValueError(f"{topo.name}: topology must be a single full cycle")


@table_cache(maxsize=64)
def _source_table(topo, device) -> torch.Tensor:
    """[n, n] long: entry (d, t) = origin shard PE d holds at consume t.
    Cached per device: a host-to-device copy would stall the stream."""
    _full_coverage(topo)
    return torch.as_tensor(topo_lib.source_table(topo), dtype=torch.long,
                           device=device)


@table_cache(maxsize=64)
def _dest_table(topo, device) -> torch.Tensor:
    """[n, n] long ``topology.dest_table``, cached per device."""
    _full_coverage(topo)
    return torch.as_tensor(topo_lib.dest_table(topo), dtype=torch.long,
                           device=device)


def _chunks(x, n: int):
    """[n_pe, ..., S, f] -> [n_pe, L, n, S/n, f] (L = prod of ...)."""
    return x.reshape(x.shape[0], -1, n, x.shape[-2] // n, x.shape[-1])


def ring_ag_matmul(x_local, ws: Sequence[torch.Tensor], topo,
                   mode: str = "qlr", block: int = 0):
    """All-gather(x) @ w_i for each w_i, streamed around a ring.

    x_local: [n, ..., s_local, d] — each PE's shard of the streamed operand.
    ws:      list of [n, d, f_local] resident weights (each PE's slice).
    Returns: list of [n, ..., n*s_local, f_local] full outputs per PE.

    At hop t PE d holds the shard of origin ``source_table[d, t]`` and
    writes its partial products at that offset. ``block`` is every
    consume's tile (``tile_matmul``).
    """
    n = topo.size
    s_local = x_local.shape[-2]
    queues.check_mode(mode, baseline=True)
    if mode == "baseline":
        xs = torch.cat(x_local.unbind(0), dim=-2)          # all-gather
        xs = xs.unsqueeze(0).expand(n, *xs.shape)
        linkstats.record_multicast(x_local, fan_in=n)
        return [tile_matmul(xs, w, block=block) for w in ws]

    src_table = _source_table(topo, x_local.device)
    pe = torch.arange(n, device=x_local.device)
    lead = x_local.shape[1:-2]
    outs = [
        torch.zeros((n, *lead, n * s_local, w.shape[-1]),
                    dtype=torch.promote_types(x_local.dtype, w.dtype),
                    device=x_local.device)
        for w in ws
    ]

    def consume(state, buf, t):
        src = src_table[:, t]
        for o, w in zip(state, ws):
            part = tile_matmul(buf, w, block=block)
            # o is updated in place: each PE writes its chunk at its origin
            o.view(n, -1, n, s_local, o.shape[-1])[pe, :, src] = \
                part.reshape(n, -1, s_local, w.shape[-1]).to(o.dtype)
        return state

    state, _ = queues.stream(topo, x_local, n, consume, outs, mode)
    return state


def ring_matmul_rs(x, w, topo, mode: str = "qlr", block: int = 0):
    """(x @ w) reduce-scattered over the sequence dim, as a ring of
    travelling accumulators.

    x: [n, ..., S, f_local], w: [n, f_local, d]. Returns [n, ..., S/n, d]:
    PE d's chunk ``d``, fully reduced over the ring. PE d computes, at step
    t, the chunk owned by the PE its accumulator finally lands on
    (``dest_table[d, t]``). Each partial folds into the travelling
    accumulator inside one tile-matmul call (the kernel's carry-in). The
    accumulator starts in the activation type and is rounded to it after
    every hop, as in the reference. ``block`` is every consume's tile.
    """
    n = topo.size
    s = x.shape[-2]
    queues.check_mode(mode, baseline=True)
    if s % n:
        raise ValueError(f"sequence {s} does not divide the ring size {n}")
    s_local = s // n
    lead = x.shape[1:-2]
    if mode == "baseline":
        y = tile_matmul(x, w, block=block)
        y_s = _chunks(y, n).sum(dim=0)                      # reduce ...
        y_s = y_s.permute(1, 0, 2, 3).reshape(n, *lead, s_local,
                                             w.shape[-1])   # ... scatter
        linkstats.record_multicast(y_s, fan_in=n)   # n partials per chunk
        return y_s

    dst_table = _dest_table(topo, x.device)
    pe = torch.arange(n, device=x.device)
    hops = topo_lib.hop_topos(topo)
    xc_all = _chunks(x, n)

    def part(t, acc=None):
        xc = xc_all[pe, :, dst_table[:, t]]                  # [n, L, s_l, f]
        xc = xc.reshape(n, *lead, s_local, x.shape[-1])
        return tile_matmul(xc, w, acc, block=block)

    acc = part(0)
    for t in range(1, n):
        # every mode hops, then folds the next partial into what arrived;
        # the reference's xqueue/sw barrier only pins this same order
        moved = queues.hop(hops[t - 1], acc, mode, t=t - 1)
        acc = part(t, moved)
    return acc


def cannon_topologies(axis: str, rows: int,
                      cols: int) -> tuple[Topology, Topology]:
    """(left, up): Cannon's shift topologies on an RxC fold — A tiles move
    left along the rows, B tiles up along the columns. Built as the
    reference's benchmarks build them, by inverting ``torus_shift``
    right and down."""
    rt = torus_shift(axis, rows, cols, direction="right")
    ct = torus_shift(axis, rows, cols, direction="down")
    left = Topology("left", axis, rows * cols,
                    tuple((d, s) for s, d in rt.perm))
    up = Topology("up", axis, rows * cols, tuple((d, s) for s, d in ct.perm))
    return left, up


@table_cache(maxsize=64)
def _rot_masks(times: tuple, n: int, device) -> torch.Tensor:
    """[n-1, P] bool: entry (i, d) is True while PE d still rotates at
    masked hop i (i < times[d]). Cached per device."""
    return (torch.arange(n - 1)[:, None] < torch.tensor(times)[None]) \
        .to(device)


def _masked_rot(x, topo: Topology, times: tuple, n: int, mode: str = "qlr",
                t0: int = 0):
    """Rotate PE d's ``x`` ``times[d]`` hops along ``topo``: n-1 hops, PE d
    keeping its value once hop i >= times[d]. The loop always runs n-1 hops
    over the requested link mode: that is the masked skew's cost. Hop i
    carries sequence number ``t0 + i``, so a fault spec can reach the skew
    traffic."""
    masks = _rot_masks(tuple(times), n, x.device)
    x0 = x
    with linkstats.mute():
        for i in range(n - 1):
            moved = queues.hop(topo, x, mode, t=t0 + i)
            x = torch.where(masks[i].view(-1, *([1] * (x.dim() - 1))),
                            moved, x)
    linkstats.record_hops(x0, n - 1)      # the skew always runs n-1 hops
    return x


@table_cache(maxsize=16)
def _cannon_sources(n: int, preskewed: bool, device):
    """([n, P], [n, P]) long: the PEs whose A and B tiles PE (r, c) reads
    at step t, k = (r + c + t) mod n, in the baseline's shared-memory
    form. Unskewed, PE (r, c) holds A[r, c] and B[r, c]; preskewed, it
    holds A[r, (r + c) mod n] and B[(r + c) mod n, c]."""
    a_src = torch.empty(n, n * n, dtype=torch.long)
    b_src = torch.empty(n, n * n, dtype=torch.long)
    for t in range(n):
        for r in range(n):
            for c in range(n):
                k = (r + c + t) % n
                a_col = (k - r) % n if preskewed else k
                b_row = (k - c) % n if preskewed else k
                a_src[t, r * n + c] = r * n + a_col
                b_src[t, r * n + c] = b_row * n + c
    return a_src.to(device), b_src.to(device)


def cannon_matmul(a_local, b_local, row_topo: Topology, col_topo: Topology,
                  rows: int, cols: int, mode: str = "qlr",
                  preskewed: bool = False, skew: str = "masked",
                  block: int = 0):
    """2-D output-stationary systolic matmul (Cannon) on an RxC grid folded
    from the PE axis. PE r*cols + c ends with C tile sum_k A[r,k] B[k,c].

    a_local: [P, m, k] — A tiles; b_local: [P, k, n] — B tiles, PE (r, c)
    holding A[r, c] and B[r, c] (already skewed when ``preskewed``).
    row_topo / col_topo: the left / up shifts (``cannon_topologies``).
    Each of the n consumes is one ``tile_matmul`` launch over all PEs,
    carrying the accumulator (fp32 for fp32 tiles); n-1 hops per operand
    follow all but the last.

    skew="masked" rotates A row r left r times and B column c up c times
    with n-1 masked hops each, over the requested link mode. skew="grid"
    re-points the queues to the ``topology.cannon_skew`` permutations and
    does the whole skew in ONE hop per operand (A's with sequence number
    n-1, B's with n): 2 hops in place of 2(n-1), the same values.
    ``baseline`` is the shared-memory form: no hops; at step t each PE
    gathers the tiles it needs, so it runs the same n launches on the same
    operands, and every mode gives identical values. ``block`` is every
    step's tile (``tile_matmul``).
    """
    if rows != cols:
        raise ValueError("Cannon requires a square grid")
    if skew not in ("masked", "grid"):
        raise ValueError(f"unknown skew {skew!r}")
    queues.check_mode(mode, baseline=True)
    n = rows
    if a_local.shape[0] != n * n or b_local.shape[0] != n * n:
        raise ValueError(f"cannon_matmul: {rows}x{cols} grid, tiles "
                         f"{tuple(a_local.shape)} / {tuple(b_local.shape)}")
    acc = None
    if mode == "baseline":
        a_src, b_src = _cannon_sources(n, preskewed, a_local.device)
        for t in range(n):
            acc = tile_matmul(a_local.index_select(0, a_src[t]),
                              b_local.index_select(0, b_src[t]), acc,
                              block=block)
        return acc
    if not preskewed and skew == "grid":
        a_local = queues.hop(cannon_skew(row_topo.axis, rows, cols,
                                         which="rows"), a_local, mode,
                             t=n - 1)
        b_local = queues.hop(cannon_skew(row_topo.axis, rows, cols,
                                         which="cols"), b_local, mode, t=n)
    elif not preskewed:
        pe = range(n * n)
        a_local = _masked_rot(a_local, row_topo, tuple(d // cols for d in pe),
                              n, mode, t0=n - 1)
        b_local = _masked_rot(b_local, col_topo, tuple(d % cols for d in pe),
                              n, mode, t0=n - 1)
    for t in range(n):
        last = t == n - 1
        if mode == "qlr" and not last:   # next operands in flight first
            nxt = (queues.hop(row_topo, a_local, mode, t=t),
                   queues.hop(col_topo, b_local, mode, t=t))
        acc = tile_matmul(a_local, b_local, acc, block=block)
        if not last:
            if mode != "qlr":
                nxt = (queues.hop(row_topo, a_local, mode, t=t),
                       queues.hop(col_topo, b_local, mode, t=t))
            a_local, b_local = nxt
    return acc


def cannon_tiles(x, rows: int, cols: int):
    """Global [M, K] -> per-PE tiles [rows*cols, M/rows, K/cols], PE
    r*cols + c holding block (r, c)."""
    m, k = x.shape
    return x.reshape(rows, m // rows, cols, k // cols).transpose(1, 2) \
        .reshape(rows * cols, m // rows, k // cols)


def cannon_untile(tiles, rows: int, cols: int):
    """Per-PE tiles [rows*cols, m, n] -> the global [rows*m, cols*n]."""
    _, m, n = tiles.shape
    return tiles.reshape(rows, cols, m, n).transpose(1, 2) \
        .reshape(rows * m, cols * n)


def systolic_cannon(a, b, n: int, mode: str = "qlr", skew: str = "masked"):
    """A @ B by Cannon on an n x n fold of n*n PEs: the tile layout that
    ``shard_map``'s specs give in the reference benchmarks, the skew
    (``masked`` or ``grid``), and the re-assembly of the C tiles.
    a: [M, K], b: [K, N]."""
    left, up = cannon_topologies("pe", n, n)
    c = cannon_matmul(cannon_tiles(a, n, n), cannon_tiles(b, n, n), left,
                      up, n, n, mode, skew=skew)
    return cannon_untile(c, n, n)


def ffn_applicable(x, d_ff: int, n_pe: int) -> bool:
    if not n_pe:
        return False
    _, s, _ = x.shape
    return s % n_pe == 0 and d_ff % n_pe == 0


def attn_applicable(x, num_heads: int, num_kv_heads: int, head_dim: int,
                    n_pe: int) -> bool:
    if not n_pe:
        return False
    _, s, _ = x.shape
    return s % n_pe == 0 and num_heads % n_pe == 0 \
        and num_kv_heads % n_pe == 0


def _seq_shards(x, n: int):
    """Global [B, S, ...] -> per-PE [n, B, S/n, ...]."""
    b, s = x.shape[:2]
    return x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1)


def _seq_unshard(y):
    """Per-PE [n, B, s_l, ...] -> global [B, n*s_l, ...]."""
    n, b, s_l = y.shape[:3]
    return y.transpose(0, 1).reshape(b, n * s_l, *y.shape[3:])


def systolic_qkv(x, wq, wk, wv, n_pe: int, mode: str = "qlr", *,
                 topo=None, block: int = 0):
    """QKV projections as ONE systolic ring: the x stream feeds three
    weight sinks (the paper's data reuse).

    x: [B,S,D], sequence-sharded over the ring; w*: [D, H*, hd],
    head-sharded. Returns the global q, k, v: [B, S, H*, hd].
    """
    topo = topo or ring("model", n_pe)
    x_l = _seq_shards(x, n_pe)

    def head_slices(w):
        d, h, hd = w.shape
        return w.reshape(d, n_pe, h // n_pe, hd).permute(1, 0, 2, 3) \
            .reshape(n_pe, d, (h // n_pe) * hd)

    ws = [head_slices(w) for w in (wq, wk, wv)]
    outs = ring_ag_matmul(x_l, ws, topo, mode, block)

    def unflat(y, w):                       # [n, B, S, H_l*hd] -> global
        n, b, s, _ = y.shape
        h, hd = w.shape[1], w.shape[2]
        return y.reshape(n, b, s, h // n, hd).permute(1, 2, 0, 3, 4) \
            .reshape(b, s, h, hd)

    return tuple(unflat(y, w) for y, w in zip(outs, (wq, wk, wv)))


def systolic_out_proj(attn_out, wo, n_pe: int, mode: str = "qlr", *,
                      topo=None, block: int = 0):
    """Attention output projection with a reduce-scatter ring: partial sums
    over the head shards travel to their sequence-shard owners.

    attn_out: [B,S,H,hd] head-sharded; wo: [H, hd, D]. Returns [B,S,D].
    """
    topo = topo or ring("model", n_pe)
    b, s, h, hd = attn_out.shape
    o_l = attn_out.reshape(b, s, n_pe, (h // n_pe) * hd).permute(2, 0, 1, 3)
    w_l = wo.reshape(n_pe, (h // n_pe) * hd, wo.shape[2])
    y = ring_matmul_rs(o_l, w_l, topo, mode, block)
    return _seq_unshard(y)


def systolic_ffn(x, w_gate, w_up, w_down, n_pe: int, mode: str = "qlr", *,
                 topo=None, block: int = 0):
    """SwiGLU FFN with systolic sequence-parallel rings:

      x (seq-sharded) --AG-ring--> [gate|up] (one stream, two weight sinks)
      --silu*-- h --RS-ring--> y (seq-sharded)

    x: [B,S,D]; w_gate/w_up: [D,F] and w_down: [F,D], split over F.
    Returns [B,S,D].
    """
    topo = topo or ring("model", n_pe)
    d, f = w_gate.shape
    x_l = _seq_shards(x, n_pe)
    wg = w_gate.reshape(d, n_pe, f // n_pe).transpose(0, 1)
    wu = w_up.reshape(d, n_pe, f // n_pe).transpose(0, 1)
    wd = w_down.reshape(n_pe, f // n_pe, d)
    gate, up = ring_ag_matmul(x_l, [wg, wu], topo, mode, block)
    h = F.silu(gate) * up                                  # [n, B, S, f_l]
    y = ring_matmul_rs(h, wd, topo, mode, block)
    return _seq_unshard(y)
