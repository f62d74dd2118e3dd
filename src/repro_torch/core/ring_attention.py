"""Sequence-parallel systolic (ring) attention on the emulated PE ring.

Prefill (``ring_attention``): each PE keeps its query shard resident while
K/V blocks travel the ring; every hop folds the arriving block into the
carried online-softmax state (m, l, acc). Decode
(``ring_decode_attention``): the dual, with the KV cache shards resident
and each PE's slice of decode queries streaming around the ring with its
state (``queues.stream_carry``), home complete after n hops.

Every hop is one call of the flash-carry wrapper for all PEs at once (the
CUDA kernel for tensors on the card, its plain twin on the CPU): the PE
axis is folded into the kernel's batch rows, so each row carries its own
query and key offsets. ``baseline`` all-gathers K/V (the shared-memory
multicast) and makes one pass.

Prefill runs on any full-coverage schedule, 2-D grids included (the
online-softmax fold is arrival-order independent: masks are by position).
Decode needs a single cycle and refuses a grid up front.

Masked scores use the finite sentinel ``-1e30``: causal ring order
delivers fully masked blocks first, and ``-inf`` would give NaN in
``exp(m - m_new)``.

Telemetry counts the reference's queue layout: prefill K and V ride two
queues here but one stacked ``[2, ...]`` element there, so the stream
records that element (``record_as``); the decode element (the fp32 query
and the carried (m, l, acc)) has the reference's shapes per PE. The
baselines record their all-gathers as multicast loads.
"""
from __future__ import annotations

import torch

from repro_torch.core import queues
from repro_torch.core.collective_matmul import _source_table
from repro_torch.core.topology import GridSchedule, Topology, ring
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.obs import linkstats

MODES = ("baseline",) + queues.MODES


def ring_attention(q_local, k_local, v_local, topo,
                   mode: str = "qlr", *, causal: bool = True,
                   window: int = 0, scale=None):
    """Systolic attention over one ring, every PE at once.

    q_local:         [n, B, sq, H, hd] — each PE's resident query shard
                     (global positions ``my*sq + i``).
    k_local/v_local: [n, B, s_local, Kv, hd] — each PE's K/V shard, pushed
                     around the ring; at hop t PE d holds the shard of
                     origin ``source_table[d, t]``. ``topo`` is a
                     single-cycle Topology or a GridSchedule.
    scale:           the scores' scale (None: 1/sqrt(hd)).

    Returns [n, B, sq, H, hd] fp32 — each PE's output for its query shard.
    """
    queues.check_mode(mode, baseline=True)
    n, b, sq, h, hd = q_local.shape
    s_local = k_local.shape[2]
    dev = q_local.device
    rows = n * b
    pe = torch.arange(n, device=dev)
    q_off = (pe * sq).repeat_interleave(b)                  # [n*B]
    q_rows = q_local.reshape(rows, sq, h, hd)
    state0 = flash_ops.zero_state(rows, h, sq, hd, dev)

    if mode == "baseline":
        # shared-memory multicast: every PE reads the full K/V
        ks = torch.cat(k_local.unbind(0), dim=1)            # [B, n*s_l, ...]
        vs = torch.cat(v_local.unbind(0), dim=1)
        linkstats.record_multicast((k_local, v_local), fan_in=n)
        kv_rows = torch.arange(b, device=dev).repeat(n)     # PE d, row i -> i
        m, l, acc = flash_ops.flash_hop(
            q_rows, ks, vs, state0, q_offset=q_off, k_offset=0,
            causal=causal, window=window, kv_rows=kv_rows, scale=scale)
    else:
        src_table = _source_table(topo, dev)

        def consume(state, kv, t):
            # one call per hop: the arriving blocks of all PEs fold
            # straight into their carried (m, l, acc)
            k_rows = kv[0].reshape(rows, s_local, *kv[0].shape[3:])
            v_rows = kv[1].reshape(rows, s_local, *kv[1].shape[3:])
            k_off = (src_table[:, t] * s_local).repeat_interleave(b)
            return flash_ops.flash_hop(
                q_rows, k_rows, v_rows, state, q_offset=q_off,
                k_offset=k_off, causal=causal, window=window, scale=scale)

        # K and V ride two queues of the same link, hopping in lockstep;
        # the reference's one stacked element is what telemetry counts
        stacked = torch.empty((n, 2, *k_local.shape[1:]),
                              dtype=k_local.dtype, device="meta")
        (m, l, acc), _ = queues.stream(topo, (k_local, v_local), n, consume,
                                       state0, mode, record_as=stacked)

    out = acc / torch.clamp(l, min=1e-30)[..., None]         # [n*B,H,sq,hd]
    return out.transpose(1, 2).reshape(n, b, sq, h, hd)


def ring_attn_applicable(q, k, n_pe: int) -> bool:
    """Shapes admit the sequence-parallel ring schedule on this ring."""
    if n_pe < 2:
        return False
    _, s, h, _ = q.shape
    kvh = k.shape[2]
    return k.shape[1] == s and s % n_pe == 0 and h % kvh == 0


def systolic_ring_attention(q, k, v, n_pe: int, mode: str = "qlr", *,
                            causal: bool = True, window: int = 0,
                            topo=None, scale=None):
    """Ring attention over ``n_pe`` emulated PEs: sequence sharded, heads
    whole. q: [B,S,H,hd], k/v: [B,S,Kv,hd]. Returns [B,S,H,hd] fp32.
    ``topo`` overrides the +1 ring with any schedule of ``n_pe`` PEs, a
    2-D grid included."""
    topo = topo or ring("model", n_pe)
    if topo.size != n_pe:
        raise ValueError(f"topology of {topo.size} PEs for a ring of {n_pe}")

    def shards(x):
        b, s = x.shape[:2]
        return x.reshape(b, n_pe, s // n_pe, *x.shape[2:]).transpose(0, 1)

    out = ring_attention(shards(q), shards(k), shards(v), topo, mode,
                         causal=causal, window=window, scale=scale)
    n, b, sq = out.shape[:3]
    return out.transpose(0, 1).reshape(b, n * sq, *out.shape[3:])


# ---------------------------------------------------------------------------
# Decode: resident KV shards, streamed queries (the serving dual)
# ---------------------------------------------------------------------------


def ring_decode_attention(q_local, k_cache, v_cache, pos, topo: Topology,
                          mode: str = "qlr"):
    """Ring decode attention, every PE at once.

    q_local:  [n, b_loc, 1, H, hd] — PE d's slice of the decode batch
              (global rows ``d*b_loc + i``); rides the ring with its state.
    k_cache/v_cache: [B, S, Kv, hd] — the global cache. Its slot dimension
              is the ring's resident operand: PE d holds slots
              ``[d*s_loc, (d+1)*s_loc)`` of every row, read in place.
    pos:      [B] int — slot j is valid for row b iff j <= pos[b].

    Returns [n, b_loc, 1, H, hd] fp32. A GridSchedule raises ``TypeError``
    (the reference's ``stream_carry`` refuses one).
    """
    queues.check_mode(mode, baseline=True)
    if isinstance(topo, GridSchedule):
        raise TypeError(f"{topo.name}: ring decode needs a single-cycle "
                        "Topology (ring or snake_fold)")
    n, b_loc, _, h, hd = q_local.shape
    bsz, s_all = k_cache.shape[:2]
    s_loc = s_all // n
    dev = q_local.device
    rows = n * b_loc
    pe = torch.arange(n, device=dev)
    local = torch.arange(b_loc, device=dev)
    pe_of_row = pe.repeat_interleave(b_loc)                 # [n*b_loc]
    state0 = flash_ops.zero_state(rows, h, 1, hd, dev)
    q32 = q_local.float()

    if mode == "baseline":
        # shared-memory multicast: every PE reads the full cache, then one
        # dense pass for its own query slice (rows d*b_loc + i)
        q_rows = q32.reshape(rows, 1, h, hd)
        linkstats.record_multicast((k_cache, v_cache), fan_in=n)
        m, l, acc = flash_ops.flash_hop(
            q_rows, k_cache, v_cache, state0, q_offset=0, k_offset=0,
            k_len=pos + 1, causal=False, window=0)
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # [rows,H,1,hd]
        return out.transpose(1, 2).reshape(n, b_loc, 1, h, hd)

    src_table = _source_table(topo, dev)
    # PE d's resident shard of cache row r is row r*n + d of this view
    k_shards = k_cache.view(bsz * n, s_loc, *k_cache.shape[2:])
    v_shards = v_cache.view(bsz * n, s_loc, *v_cache.shape[2:])
    k_off = pe_of_row * s_loc                                # [rows]

    def update(q_stream, state, t):
        # the element on PE d at hop t originated at src: fold PE d's
        # resident slots of *that* slice's rows into it
        src = src_table[:, t]
        cache_row = (src[:, None] * b_loc + local[None, :]).reshape(rows)
        kv_rows = cache_row * n + pe_of_row
        pos_blk = pos[cache_row]
        flat = tuple(x.reshape(rows, *x.shape[2:]) for x in state)
        q_rows = q_stream.reshape(rows, 1, h, hd)
        # per-row bound pos+1 reproduces `slot <= pos` with causal=False
        new = flash_ops.flash_hop(
            q_rows, k_shards, v_shards, flat, q_offset=0,
            k_offset=k_off, k_len=pos_blk + 1, causal=False, window=0,
            kv_rows=kv_rows)
        return tuple(x.reshape(n, b_loc, *x.shape[1:]) for x in new)

    carry0 = tuple(x.reshape(n, b_loc, *x.shape[1:]) for x in state0)
    _, (m, l, acc) = queues.stream_carry(topo, q32, carry0, n, update, mode)
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # [n,b_loc,H,1,hd]
    return out.transpose(2, 3)


def ring_decode_applicable(q, k_cache, n_pe: int) -> bool:
    """A ring of >= 2, cache slots dividing it, and the decode batch
    dividing it so every PE owns a query slice."""
    if n_pe < 2:
        return False
    b, sq, h, _ = q.shape
    kvh = k_cache.shape[2]
    return (sq == 1 and k_cache.shape[0] == b
            and k_cache.shape[1] % n_pe == 0 and b % n_pe == 0
            and h % kvh == 0)


def systolic_ring_decode(q, k_cache, v_cache, pos, n_pe: int,
                         mode: str = "qlr", *, topo=None):
    """Ring-sharded decode attention over ``n_pe`` emulated PEs.
    q: [B,1,H,hd]; k_cache/v_cache: [B,S,Kv,hd]; pos: [B]. Returns
    [B,1,H,hd] fp32. ``topo`` must be a single full cycle."""
    topo = topo or ring("model", n_pe)
    if topo.size != n_pe:
        raise ValueError(f"topology of {topo.size} PEs for a ring of {n_pe}")
    b = q.shape[0]
    out = ring_decode_attention(q.reshape(n_pe, b // n_pe, *q.shape[1:]),
                                k_cache, v_cache, pos, topo, mode)
    return out.reshape(b, *out.shape[2:])
