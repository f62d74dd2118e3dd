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

Robustness and telemetry, as in the reference:

* **fault injection** — when a :mod:`repro_torch.core.faults` spec is
  active, every ``hop`` that knows its hop index ``t`` applies it at the
  targeted (hop, PE). Hop sites pass ``t`` wherever the reference passes
  it, so one ``FaultSpec`` hits the same (hop, PE) in both packages.
* **checked links** (``checked=True`` on ``hop``/``stream``/
  ``stream_carry``) — each message rides a sidecar of (sender id, hop
  sequence number, payload ``checksum``), hopped as three more queues of
  ``[n_pe]``; the receiver verifies them and returns per-PE health flags
  ``[tag_error, checksum_error]``. Stuck or late links (stale, slow)
  freeze the whole message and trip the tag check; data-word faults
  (corrupt, drop) touch only the payload and trip the checksum check. The
  sidecar never changes the payload.
* **telemetry** — with a :mod:`repro_torch.obs.linkstats` scope armed,
  every hop records its queue traffic; the stream drivers mute their hop
  loop and record the whole circuit once, as the reference records after
  its ``lax.scan``.

2-D grid schedules (``topology.GridSchedule``: torus2d, cannon_grid) ride
``stream`` too: hop ``t`` takes the schedule's own permutation
``hops[t]``, and Cannon's skew hops once before consume 0 with sequence
number ``n_steps``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.core import faults
from repro_torch.core.topology import GridSchedule, Topology
from repro_torch.kernels._build import fake_mode_active
from repro_torch.obs import linkstats

MODES = ("sw", "xqueue", "qlr")


def table_cache(maxsize: int):
    """``functools.lru_cache`` for builders of constant tensors (index
    tables, twiddles), which build them outside inference mode: a table
    first built while serving (``torch.inference_mode``) would be an
    inference tensor, which autograd refuses to save when a training step
    later indexes with it. Under a dry run's ``FakeTensorMode`` the table
    is built anew and not cached: a fake table must not outlive its mode,
    nor reach a real run."""
    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        def build(*args):
            with torch.inference_mode(False):
                return fn(*args)

        @functools.wraps(fn)
        def cached(*args):
            if fake_mode_active():
                return fn(*args)
            return build(*args)
        cached.cache_clear = build.cache_clear
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


def hop(topo: Topology, x, mode: str = "qlr", *, t=None, prev=None,
        checked: bool = False):
    """One systolic hop: every PE pushes its element to its linked
    neighbor and pops its predecessor's. ``x`` is a tensor or a tuple of
    tensors, each with the PE dimension first.

    ``t`` is the hop's sequence number within its schedule: passing it
    lets a fault spec target this hop (and ``checked`` needs it). ``prev``
    is what a stuck pop returns instead (default ``x``, the receiving PE's
    own pre-hop element). With ``checked=True`` returns ``(popped,
    health)``, health int32 ``[n_pe, 2]`` = (tag_err, csum_err) per PE.
    """
    check_mode(mode)
    if checked:
        payload, health = _checked_hop(topo, x, mode, t=t, prev=prev)
        linkstats.record_hops(x, 1, health=health)
        return payload, health
    moved = _hop_leaves(topo, x, mode)
    vec = faults.active_vec()
    if vec is not None and t is not None:
        moved = faults.apply(vec, moved, x if prev is None else prev, t)
    linkstats.record_hops(x, 1)
    return moved


def _hop_leaves(topo: Topology, x, mode: str):
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


# ---------------------------------------------------------------------------
# checked links: sequence tag + payload checksum sidecar
# ---------------------------------------------------------------------------


def checksum(tree) -> torch.Tensor:
    """Order-independent int32 digest of each PE's payload bits: ``[n_pe]``
    for an element (a tensor or tuple of tensors, PE dimension first).

    As in the reference, floats are widened to fp32 (exact) and bitcast to
    int32, bool and int leaves are cast to int32, and everything is summed
    with int32 wraparound: the sum runs in int64 and is wrapped once, which
    gives the same bits since addition modulo 2**32 is associative. NaN
    corruption, dropped (zeroed) payloads and bit flips all change the
    digest; an all-zero payload is the blind spot (its digest is 0 like a
    dropped message's; the sequence tag still covers stuck links there)."""
    tot = None
    for leaf in _leaves(tree):
        if leaf.is_floating_point():
            bits = leaf.float().contiguous().view(torch.int32)
        else:
            bits = leaf.to(torch.int32)
        s = bits.reshape(bits.shape[0], -1).sum(dim=1, dtype=torch.int64)
        tot = s if tot is None else tot + s
    return (torch.remainder(tot + 2 ** 31, 2 ** 32) - 2 ** 31) \
        .to(torch.int32)


@table_cache(maxsize=64)
def _pred_table(topo: Topology, device: torch.device):
    """(my, pred) int32 ``[n]``: each PE's own id (its sender stamp) and the
    PE whose pushes it pops. Heads of open chains keep 0, as in the
    reference: checked links assume every PE has one incoming link."""
    pred = [0] * topo.size
    for s, d in topo.perm:
        pred[d] = s
    return (torch.arange(topo.size, dtype=torch.int32, device=device),
            torch.tensor(pred, dtype=torch.int32, device=device))


def _checked_hop(topo: Topology, x, mode: str, *, t, prev=None):
    """One hop with the (src, seq, checksum) sidecar riding alongside.

    Returns (popped_payload, health) with health int32 ``[n_pe, 2]``:
      [:, 0] — tag error: the message was stamped by the wrong sender
               (stale: the PE's own id) or with the wrong sequence number
               (slow: the previous hop's) — a stuck or late link.
      [:, 1] — checksum error: the payload bits do not match the digest
               stamped at push time — corruption or a drop in the data
               FIFOs while the control FIFO survived.
    """
    if t is None:
        raise ValueError("checked hops need their hop index t")
    leaves = tuple(_leaves(x))
    k = len(leaves)
    my, pred = _pred_table(topo, leaves[0].device)
    seq = torch.full_like(my, t)
    msg = (*leaves, my, seq, checksum(x))
    moved = _hop_leaves(topo, msg, mode)
    vec = faults.active_vec()
    if vec is not None:
        held = leaves if prev is None else tuple(_leaves(prev))
        # data-word faults clobber only the payload FIFOs ...
        payload = faults.apply(vec, moved[:k], held, t, data_only=True)
        # ... while a stuck link freezes payload and sidecar together
        moved = faults.apply(vec, (*payload, *moved[k:]), msg, t,
                             stall_only=True)
    payload, (src_tag, seq_tag, csum) = moved[:k], moved[k:]
    tag_err = (src_tag != pred) | (seq_tag != t)
    csum_err = checksum(payload) != csum
    health = torch.stack([tag_err, csum_err], dim=-1).to(torch.int32)
    return _rebuild(x, payload), health


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


def stream(topo, x0, n_steps: int,
           consume: Callable[[Any, Any, int], Any], state0,
           mode: str = "qlr", checked: bool = False, record_as=None):
    """Drive a systolic stream: per step, consume the current operand and
    forward it along the topology. ``consume(state, operand, t) -> state``.
    Returns (state, buffer after ``n_steps`` hops).

    ``topo`` is a Topology or a ``GridSchedule``, whose hop ``t`` rides
    ``hops[t]`` and whose skew, when it has one, hops once before consume
    0 with sequence number ``n_steps`` (so a fault spec or a checked link
    can target it); a grid needs ``n_steps == len(hops) == size``.

    checked=True: every hop rides the tag/checksum sidecar; returns
    (state, buf, health) with health int32 ``[n_pe, n_steps, 2]``, each
    PE's per-hop (tag_err, csum_err) flags (the reference's per-device
    ``[n_steps, 2]``, stacked over PEs). A grid's skew health folds into
    hop 0's row.

    Telemetry records the circuit once, as ``n_steps`` hops of ``x0``'s
    queue set (and the skew hop, for a grid); ``record_as`` names another
    layout to count (a tensor or tuple whose leaves have the shapes and
    types of the reference's queue element, e.g. on the ``meta`` device)
    where the port carries the element in another form.
    """
    check_mode(mode)
    hops = [topo] * n_steps
    skew = None
    if isinstance(topo, GridSchedule):
        if not n_steps == len(topo.hops) == topo.size:
            raise ValueError(f"{topo.name}: a grid stream runs one hop per "
                             f"PE ({topo.size}), not {n_steps}")
        hops, skew = list(topo.hops), topo.skew
    buf, state = x0, state0
    healths, skew_health = [], None
    with linkstats.mute():
        if skew is not None:        # Cannon's start offsets, before consume 0
            buf = hop(skew, buf, mode, t=n_steps, checked=checked)
            if checked:
                buf, skew_health = buf
        for t in range(n_steps):
            to_consume, to_hop = _fork(buf)
            if mode == "qlr":       # the hop is issued before the consume
                nxt = hop(hops[t], to_hop, mode, t=t, checked=checked)
                state = consume(state, to_consume, t)
            else:                   # the hop is serialized after it
                state = consume(state, to_consume, t)
                nxt = hop(hops[t], to_hop, mode, t=t, checked=checked)
            if checked:
                nxt, health = nxt
                healths.append(health)
            buf = nxt
    health = torch.stack(healths, dim=1) if checked else None
    counted = x0 if record_as is None else record_as
    if skew is not None:            # the reference records every grid hop
        linkstats.record_hops(counted, 1, health=skew_health)
    linkstats.record_hops(counted, n_steps, health=health)
    if checked:
        if skew_health is not None:
            health = torch.cat([health[:, :1] + skew_health[:, None],
                                health[:, 1:]], dim=1)
        return state, buf, health
    return state, buf


def stream_carry(topo: Topology, static0, carry0, n_steps: int,
                 update: Callable[[Any, Any, int], Any], mode: str = "qlr",
                 checked: bool = False):
    """Drive a stream whose element itself carries state: the travelling
    element is (static, carry) and each holder folds its resident operand
    into the carried part, ``update(static, carry, t) -> carry``, before
    the element hops on. This is the decode-attention schedule: the query
    (static) rides the ring with its online-softmax state (carry) and is
    home, complete, after ``n_steps`` hops of an n-cycle.

    qlr hops the static half before the update (only it can go early: the
    carried half depends on the update); xqueue/sw update, then hop both.
    Returns (static, carry). checked=True rides the sidecar on both queue
    sets (static and carried halves are separate FIFOs through the same
    link) and returns (static, carry, health), health int32
    ``[n_pe, n_steps, 2]``: per-hop error counts summed over the two.
    A grid schedule raises ``TypeError``: its elements need not return
    home after n hops."""
    check_mode(mode)
    if isinstance(topo, GridSchedule):
        raise TypeError(f"{topo.name}: stream_carry needs a single-cycle "
                        "Topology; decode rides ring or snake_fold only")
    static, carry = static0, carry0
    healths = []
    with linkstats.mute():
        for t in range(n_steps):
            if mode == "qlr":
                nxt_static = hop(topo, static, mode, t=t, checked=checked)
                carry = update(static, carry, t)
                nxt_carry = hop(topo, carry, mode, t=t, checked=checked)
            else:
                carry = update(static, carry, t)
                nxt_static = hop(topo, static, mode, t=t, checked=checked)
                nxt_carry = hop(topo, carry, mode, t=t, checked=checked)
            if checked:
                (nxt_static, h_static), (nxt_carry, h_carry) = \
                    nxt_static, nxt_carry
                healths.append(h_static + h_carry)
            static, carry = nxt_static, nxt_carry
    health = torch.stack(healths, dim=1) if checked else None
    # two queue sets ride each hop; the summed health attaches to one
    # record so the error totals are not counted twice
    linkstats.record_hops(static0, n_steps, health=health)
    linkstats.record_hops(carry0, n_steps)
    if checked:
        return static, carry, health
    return static, carry


def multicast(x):
    """Shared-memory multicast: every PE reads every PE's operand (the
    all-gather, the paper's concurrent-load collective). ``x``: ``[n, ...]``
    -> ``[n, n, ...]``, PE d's row holding all n operands (a broadcast
    view; no copy)."""
    linkstats.record_multicast(x, fan_in=x.shape[0])
    return x.unsqueeze(0).expand(x.shape[0], *x.shape)


def gather_store(x):
    """Shared-memory gather: concurrent independent stores land as the
    PE-sharded output (identity: each PE keeps its tile)."""
    return x
