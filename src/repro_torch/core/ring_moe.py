"""Expert-parallel systolic MoE dispatch on the emulated PE ring.

As in the reference ``repro/core/ring_moe.py``, each PE keeps its expert
shard resident (weight-stationary: PE d owns experts ``[d*e_l, (d+1)*e_l)``)
while routed token blocks stream the ring (``queues.stream``), in two
passes:

  dispatch — each PE's token block with its routing metadata (expert ids
             and arrival ranks) rides the ring as one element of three
             queues; per hop every PE scatters the arriving tokens routed
             to its own experts into its capacity buffer. Foreign and
             overflowed assignments land on a drop sentinel row that is
             sliced off, as the reference's ``mode="drop"`` scatter.
  ffn      — the expert SwiGLU over the capacity buffers.
  combine  — the expert outputs ride the ring back; per hop every PE
             gathers from the arriving buffer the gate-weighted
             contributions owed to its own tokens, accumulated in fp32.

Every PE-local tensor carries the PE dimension first. The capacity
buffers of all PEs are one ``[E, B, C, D]`` tensor (expert-major, PE d's
experts at rows ``d*e_l ..``), so the expert FFN runs each projection as
ONE ``tile_matmul`` launch over all E experts, ``[E, B*C, D] @ [E, D, F]``
on the weights as they are stored: the reference's per-expert loop
(``_expert_ffn``), batched over the PEs as every ring op of the port is.

Capacity and overflow are exactly the dense path's: arrival ranks are
computed globally (``models.moe._positions_in_expert``) before the blocks
are sharded. ``baseline`` is the shared-memory form inside the same
harness: every PE reads every token block and every expert output by
multicast instead of queue hops. Scatter and gather address buffers by
origin id, so any full-coverage schedule (a snake fold, a 2-D grid)
combines identically.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import queues
from repro_torch.core.collective_matmul import _source_table
from repro_torch.core.topology import ring
from repro_torch.kernels.systolic_matmul.ops import tile_matmul
from repro_torch.obs import linkstats

MODES = ("baseline",) + queues.MODES


def _expert_ffn(xbuf, wg, wu, wd, block: int = 0):
    """The expert SwiGLU, each projection one tile-matmul launch over all
    experts (``block``: the launches' tile). xbuf: [E, M, D]; wg/wu:
    [E, D, F]; wd: [E, F, D]. Returns [E, M, D] in the promoted type."""
    gate = tile_matmul(xbuf, wg, block=block)
    up = tile_matmul(xbuf, wu, block=block)
    return tile_matmul(F.silu(gate) * up, wd, block=block)


def ring_moe(x_blk, idx_blk, pos_blk, w_blk, wg, wu, wd, topo, cap: int,
             mode: str = "qlr", block: int = 0):
    """Expert-ring MoE, every PE at once.

    x_blk:   [n, B, s_l, D] — each PE's token block (streamed).
    idx_blk: [n, B, s_l, K] int32 — global expert id per assignment.
    pos_blk: [n, B, s_l, K] int32 — arrival rank within the expert (a rank
             >= cap marks a capacity-overflow drop).
    w_blk:   [n, B, s_l, K] — gate weights (stay with their owner).
    wg/wu:   [E, D, F], wd: [E, F, D] — all experts as stored; PE d's
             resident shard is experts ``[d*e_l, (d+1)*e_l)``.

    Returns [n, B, s_l, D] fp32: each PE's combined output for its own
    tokens. ``block`` is the expert FFN's tile (``tile_matmul``).
    """
    queues.check_mode(mode, baseline=True)
    n, b, s_l, d = x_blk.shape
    k = idx_blk.shape[-1]
    e = wg.shape[0]
    if e % n:
        raise ValueError(f"{e} experts do not shard over {n} PEs")
    e_l = e // n
    rows = e * b * cap                          # buffer rows; + 1 sentinel
    dev = x_blk.device
    pe = torch.arange(n, device=dev)[:, None, None, None]       # [n,1,1,1]
    bi = torch.arange(b, device=dev)[None, :, None, None]       # [1,B,1,1]

    def slots(idx_b, pos_b, owner, at):
        """Buffer row of each assignment among the experts of ``owner``,
        in a buffer held at PE ``at`` (both [n,1,1,1] PE ids), and
        whether it is kept there."""
        idx_b, pos_b = idx_b.long(), pos_b.long()
        local = idx_b - owner * e_l
        ok = (local >= 0) & (local < e_l) & (pos_b < cap)
        row = ((at * e_l + local) * b + bi) * cap + pos_b
        return row, ok

    def scatter_block(xbuf, x_b, idx_b, pos_b):
        """Write the tokens routed to each PE's experts into its capacity
        slots; foreign and overflowed ones land on the sentinel row."""
        row, ok = slots(idx_b, pos_b, pe, pe)
        return xbuf.index_put_((torch.where(ok, row, rows),),
                               x_b[..., None, :])

    def gather_block(out_src, owner, at):
        """The gate-weighted contributions owed to each PE's tokens from
        the expert outputs of ``owner``, held at PE ``at``; out_src is the
        flat [E*B*C, D] buffer of all PEs."""
        row, ok = slots(idx_blk, pos_blk, owner, at)
        row = torch.clamp(row, 0, rows - 1)
        w = (w_blk * ok.to(w_blk.dtype)).float()
        y = None
        for j in range(k):
            part = out_src.index_select(0, row[..., j].reshape(-1)) \
                .reshape(n, b, s_l, d).float() * w[..., j, None]
            y = part if y is None else y + part
        return y

    xbuf0 = x_blk.new_zeros(rows + 1, d)

    def ffn(xbuf):
        return _expert_ffn(xbuf[:rows].view(e, b * cap, d), wg, wu, wd,
                           block) \
            .reshape(rows, d)

    if mode == "baseline":
        # shared-memory multicast: every PE reads every token block ...
        linkstats.record_multicast((x_blk, idx_blk, pos_blk), fan_in=n)
        whole = (x_blk.transpose(0, 1).reshape(1, b, n * s_l, d),
                 idx_blk.transpose(0, 1).reshape(1, b, n * s_l, k),
                 pos_blk.transpose(0, 1).reshape(1, b, n * s_l, k))
        xbuf = scatter_block(
            xbuf0, *(t.expand(n, *t.shape[1:]) for t in whole))
        out_e = ffn(xbuf)
        # ... and every owner reads every expert's outputs
        linkstats.record_multicast(out_e, fan_in=n)
        y = None
        for src in range(n):
            owner = torch.full_like(pe, src)
            part = gather_block(out_e, owner, owner)
            y = part if y is None else y + part
        return y

    src_table = _source_table(topo, dev)

    # ---- pass 1: token blocks ride the ring, experts fill their buffers
    def dispatch_consume(xbuf, blk, t):
        return scatter_block(xbuf, *blk)

    xbuf, _ = queues.stream(topo, (x_blk, idx_blk, pos_blk), n,
                            dispatch_consume, xbuf0, mode)

    # ---- the expert FFN (weight-stationary)
    out_e = ffn(xbuf).view(n, e_l * b * cap, d)

    # ---- pass 2: expert outputs ride the ring back to the token owners
    def combine_consume(y, out_src, t):
        part = gather_block(out_src.reshape(rows, d),
                            src_table[:, t].view(n, 1, 1, 1), pe)
        return part if y is None else y + part

    y, _ = queues.stream(topo, out_e, n, combine_consume, None, mode)
    return y


def ring_moe_applicable(cfg, x, n_pe: int) -> bool:
    """Shapes and config admit the expert-ring schedule on a ring of
    ``n_pe``: experts shard over the ring, the sequence divides it, and no
    sub-experts or shared experts (their combine belongs to the dense
    path)."""
    if n_pe < 2:
        return False
    if max(cfg.moe_subexperts, 1) > 1 or cfg.num_shared_experts:
        return False
    return cfg.num_experts % n_pe == 0 and x.shape[1] % n_pe == 0


def systolic_ring_moe(x, idx, pos, weights, wg, wu, wd, cap: int,
                      n_pe: int, mode: str = "qlr", *, topo=None,
                      block: int = 0):
    """Expert-ring MoE over ``n_pe`` emulated PEs: experts sharded
    (resident), tokens streamed.

    x: [B,S,D]; idx/pos: [B,S,K] int32; weights: [B,S,K] (routing already
    resolved, see ``models.moe.apply_moe``); wg/wu: [E,D,F], wd: [E,F,D].
    Returns y [B,S,D] fp32. ``topo`` re-points the expert ring (a
    snake_fold placement, a 2-D grid); ``block`` is the expert FFN's
    tile."""
    topo = topo or ring("model", n_pe)
    if topo.size != n_pe:
        raise ValueError(f"topology of {topo.size} PEs for a ring of {n_pe}")

    def shards(t):
        bsz, s = t.shape[:2]
        return t.reshape(bsz, n_pe, s // n_pe, *t.shape[2:]).transpose(0, 1)

    y = ring_moe(shards(x), shards(idx), shards(pos), shards(weights), wg,
                 wu, wd, topo, cap, mode, block)
    n, bsz, s_l = y.shape[:3]
    return y.transpose(0, 1).reshape(bsz, n * s_l, y.shape[-1])
