"""Systolic links on one card: the PE ring is the leading tensor dimension.

The reference runs one program per device inside ``shard_map`` and moves
operands with ``ppermute``. Here every PE-local tensor carries a leading PE
dimension ``[n_pe, ...]`` and a *hop* is a gather along that dimension by
the topology's permutation: PE ``d`` receives what its predecessor pushed.
A queue element may be a tuple of tensors; each rides its own queue (the
paper's several-queues-per-PE layout), all hopping in lockstep. On an
open topology (``topology.chains``) a PE that no link feeds pops zeros,
as ``ppermute`` gives in the reference.

The link modes are orders of operations, as in the reference:

  qlr     — the hop is issued before the consume (the next operand is in
            flight while the PE computes). On one stream this is an order
            of launches; overlapping on a side CUDA stream is later work.
  xqueue  — consume, then hop: the transfer sits on the critical path.
  sw      — xqueue plus the software FIFO's explicit circular-buffer
            bookkeeping around every transfer (``_sw_hop``).

The reference pins the xqueue/sw order with optimization barriers; eager
PyTorch already runs operations in program order, so no barrier is needed.
Modes change scheduling, never values: all three give identical results,
gradients included (``_Fork``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.core.topology import Topology

MODES = ("sw", "xqueue", "qlr")


def table_cache(maxsize: int):
    """``functools.lru_cache`` for builders of constant tensors (index
    tables, twiddles), which build them outside inference mode: a table
    first built while serving (``torch.inference_mode``) would be an
    inference tensor, which autograd refuses to save when a training step
    later indexes with it."""
    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def cached(*args):
            with torch.inference_mode(False):
                return fn(*args)
        return cached
    return wrap


@table_cache(maxsize=64)
def _pred_index(topo: Topology, device: torch.device):
    """(pred, heads): pred[d] = the PE whose push PE d pops (its topology
    predecessor); heads = the PEs that no link feeds (None on a cycle),
    whose pred is their own index and whose popped rows are zeroed."""
    pred = list(range(topo.size))
    receivers = set()
    for s, d in topo.perm:
        pred[d] = s
        receivers.add(d)
    heads = sorted(set(range(topo.size)) - receivers)
    return (torch.tensor(pred, dtype=torch.long, device=device),
            torch.tensor(heads, dtype=torch.long, device=device)
            if heads else None)


def check_mode(mode: str, baseline: bool = False) -> None:
    allowed = (("baseline",) if baseline else ()) + MODES
    if mode not in allowed:
        raise ValueError(f"unknown link mode {mode!r}; expected one of "
                         f"{allowed}")


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def _rebuild(x, leaves):
    return tuple(leaves) if isinstance(x, tuple) else leaves[0]


def _raw_hop(topo: Topology, x: torch.Tensor, pe_dim: int = 0):
    if x.shape[pe_dim] != topo.size:
        raise ValueError(f"PE dim {pe_dim} of {tuple(x.shape)} is not "
                         f"the ring size {topo.size}")
    pred, heads = _pred_index(topo, x.device)
    out = x.index_select(pe_dim, pred)
    if heads is not None:
        out.index_fill_(pe_dim, heads, 0)
    return out


def hop(topo: Topology, x, mode: str = "qlr"):
    """One systolic hop: every PE pushes its element to its linked
    neighbor and pops its predecessor's. ``x`` is a tensor or a tuple of
    tensors, each with the PE dimension first."""
    check_mode(mode)
    if mode == "sw":
        return _rebuild(x, [_sw_hop(topo, leaf) for leaf in _leaves(x)])
    return _rebuild(x, [_raw_hop(topo, leaf) for leaf in _leaves(x)])


def _sw_hop(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    """Software-queue emulation: 4-deep circular buffer with explicit
    head/tail bookkeeping around the transfer (cf. paper Fig. 3 left).
    Every PE runs the same bookkeeping, so head and tail are host ints."""
    depth = 4
    buf = x.new_zeros((depth,) + tuple(x.shape))
    head = tail = 0
    # push: boundary check, write at tail, bump tail
    nxt_tail = (tail + 1) % depth
    full = nxt_tail == head                      # boundary check (always false here)
    buf[tail] = x
    tail = tail if full else nxt_tail
    # the transfer itself: the whole buffer rides the link
    moved = _raw_hop(topo, buf, pe_dim=1)
    # pop: boundary check, read at head, bump head
    empty = head == tail
    out = moved[head]
    head = head if empty else (head + 1) % depth
    return out


class _Fork(torch.autograd.Function):
    """Two aliases of a stream operand for its two readers, the consume
    and the hop. Autograd adds the gradients of a tensor's readers in the
    order their backward runs, which the link mode sets (it orders the
    readers); this backward adds them in one order, so the modes'
    gradients stay bit-identical."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x), x.view_as(x)

    @staticmethod
    def backward(ctx, g_consume, g_hop):
        if g_consume is None or g_hop is None:
            return g_hop if g_consume is None else g_consume
        return g_consume + g_hop


def _fork(x):
    """(to_consume, to_hop): ``x`` twice, through ``_Fork`` where autograd
    records."""
    if not torch.is_grad_enabled() or not any(
            leaf.requires_grad for leaf in _leaves(x)):
        return x, x
    pairs = [_Fork.apply(leaf) for leaf in _leaves(x)]
    return (_rebuild(x, [a for a, _ in pairs]),
            _rebuild(x, [b for _, b in pairs]))


def stream(topo: Topology, x0, n_steps: int,
           consume: Callable[[Any, Any, int], Any], state0,
           mode: str = "qlr"):
    """Drive a systolic stream: per step, consume the current operand and
    forward it along the topology. ``consume(state, operand, t) -> state``.
    Returns (state, buffer after ``n_steps`` hops)."""
    check_mode(mode)
    buf, state = x0, state0
    for t in range(n_steps):
        to_consume, to_hop = _fork(buf)
        if mode == "qlr":
            nxt = hop(topo, to_hop, mode)       # issued before the consume
            state = consume(state, to_consume, t)
        else:
            state = consume(state, to_consume, t)
            nxt = hop(topo, to_hop, mode)       # serialized after it
        buf = nxt
    return state, buf


def stream_carry(topo: Topology, static0, carry0, n_steps: int,
                 update: Callable[[Any, Any, int], Any], mode: str = "qlr"):
    """Drive a stream whose element itself carries state: the travelling
    element is (static, carry) and each holder folds its resident operand
    into the carried part, ``update(static, carry, t) -> carry``, before
    the element hops on. This is the decode-attention schedule: the query
    (static) rides the ring with its online-softmax state (carry) and is
    home, complete, after ``n_steps`` hops of an n-cycle.

    qlr hops the static half before the update (only it can go early: the
    carried half depends on the update); xqueue/sw update, then hop both.
    Returns (static, carry)."""
    check_mode(mode)
    static, carry = static0, carry0
    for t in range(n_steps):
        if mode == "qlr":
            nxt_static = hop(topo, static, mode)
            carry = update(static, carry, t)
            nxt_carry = hop(topo, carry, mode)
        else:
            carry = update(static, carry, t)
            nxt_static = hop(topo, static, mode)
            nxt_carry = hop(topo, carry, mode)
        static, carry = nxt_static, nxt_carry
    return static, carry
