"""Operations, bytes and kernel launches of a step, counted as it runs: the
port's counterpart of the reference's ``roofline/hlo_parse.py``.

The reference reads FLOPs and HBM traffic off compiled HLO text. The port
runs eagerly, so :class:`Counter` is a ``TorchDispatchMode`` that sees
every aten op the step runs (forward, backward and remat recompute), and
the dry run runs the step on ``FakeTensor``s, which carry shapes, types
and devices but no data. For each op it tallies:

* FLOPs by ``torch.utils.flop_counter``'s formulas (the matmuls,
  convolutions and attention ops), split by the type they compute in;
* bytes: each tensor input read once and each output written once. In
  eager PyTorch the op boundary is the HBM boundary, as the fusion
  boundary is in ``hlo_parse``. Views, metadata and allocation-only
  factory ops move nothing and are left out (``hlo_parse``'s
  ``_TRAFFIC_EXCLUDE``). A gather reads as many elements as it writes,
  and an in-place scatter writes only the values it is given (a decode
  step writes one position of a cache it does not read whole);
* a peak of live storage bytes on the step's device, from weak references
  to the storages the ops create (the arguments are counted by the
  caller). Inside a kernel's forward the peak is not read: the CPU twin's
  temporaries are not the kernel's, while its outputs stay live and count
  at the next op.

A hand-written kernel's wrapper reports its launch through
:func:`kernel`: the counter records the kernel's ``work`` (its FLOPs,
bytes and type, from its shapes) and mutes the aten ops beneath it, the
plain twin's on the CPU and the wrapper's padding on the card, so that
the count is the same whichever implementation runs. Ops outside a
kernel's forward, such as the twins' gradients in the backward, count as
the card runs them. A flash hop counts every (query, key) pair of its
launch, live or masked: fake offsets have no values, and it is the
convention ``FlopCounterMode`` uses for the dense path's masked einsum
and ``hlo_parse`` for dots.

The ring hops' payload and multicast bytes come from
``obs/linkstats.collect()`` (host integers); they are part of the op
bytes already and are reported apart as ``link_bytes``.

:func:`trips` is ``hlo_parse``'s loop-trip multiplier: a loop whose trips
do the same work on inputs of one shape (the microbatches of a training
step) runs once under a folding counter on fake tensors, and what it
recorded counts ``k`` times.
"""
from __future__ import annotations

import weakref
from contextlib import ExitStack, contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels._build import fake_mode_active
from repro_torch.obs import linkstats

_ACTIVE: list = []          # the counters entered, innermost last

# the type an op's arithmetic runs in, by its first tensor input (complex
# arithmetic runs on fp32 parts; TF32 is off where the port is timed)
_KIND = {torch.bfloat16: "bf16", torch.float16: "fp16",
         torch.float32: "fp32", torch.complex64: "fp32"}

_aten = torch.ops.aten
# ops that move no bytes of their own besides the views (``is_view``):
# metadata, allocation without a write, and scalars read to the host
_NO_TRAFFIC = {getattr(_aten, name) for name in (
    "_unsafe_view", "alias", "detach", "lift_fresh", "_reshape_alias",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "set_", "resize_")
    if hasattr(_aten, name)}
# gathers read only the elements they index (as many as they write), and
# in-place scatters write only the elements they are given: both move
# their index and value operands, not the whole tensor they index
_GATHER = {getattr(_aten, name) for name in (
    "index", "index_select", "gather", "embedding") if hasattr(_aten, name)}
_SCATTER = {getattr(_aten, name) for name in (
    "index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_")
    if hasattr(_aten, name)}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's (nested) arguments or outputs."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def nbytes(*tensors) -> int:
    """Bytes of the given tensors' elements (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def kind_of(dtype) -> str:
    return _KIND.get(dtype, "fp32")


class Counter(TorchDispatchMode):
    """Tallies a step's ops, kernel launches, link bytes and live storage;
    ``aggregate()`` gives the totals. ``device``: the device whose
    storages the peak follows (None: every device). ``fold_loops``: let
    :func:`trips` run a repeated loop once (on fake tensors only)."""

    def __init__(self, device=None, fold_loops: bool = False):
        super().__init__()
        self.device = torch.device(device) if device is not None else None
        self.fold_loops = fold_loops
        self.flops_by_kind: dict[str, float] = {}
        self.hbm_bytes = 0
        self.by_op: dict[str, dict] = {}
        self.by_kernel: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._scale = 1
        self._muted = 0
        self._link_extra = 0
        self._links = None
        self._stack = None

    # -------------------------------------------------------------- scope
    def __enter__(self):
        self._stack = ExitStack()
        self._links = self._stack.enter_context(linkstats.collect())
        super().__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    @property
    def link_bytes(self) -> int:
        if self._links is None:
            return self._link_extra
        st = self._links.stats
        return st.payload_bytes + st.mcast_bytes + self._link_extra

    @contextmanager
    def scaled(self, k: int):
        """Count what runs in the block ``k`` times (one level deep)."""
        if self._scale != 1:
            raise RuntimeError("Counter.scaled does not nest")
        links0 = self.link_bytes
        self._scale = k
        try:
            yield
        finally:
            self._scale = 1
            self._link_extra += (self.link_bytes - links0) * (k - 1)

    # ------------------------------------------------------------ records
    def _add(self, table: dict, name: str, calls: str, flops: float,
             nbytes_: int) -> None:
        rec = table.setdefault(name, {calls: 0, "flops": 0.0, "bytes": 0})
        rec[calls] += self._scale
        rec["flops"] += flops * self._scale
        rec["bytes"] += nbytes_ * self._scale

    def _add_totals(self, flops: float, kind: str, nbytes_: int) -> None:
        if flops:
            self.flops_by_kind[kind] = (self.flops_by_kind.get(kind, 0.0)
                                        + flops * self._scale)
        self.hbm_bytes += nbytes_ * self._scale

    def record_kernel(self, name: str, flops: float, nbytes_: int,
                      kind: str) -> None:
        self._add(self.by_kernel, name, "launches", flops, nbytes_)
        self._add_totals(flops, kind, nbytes_)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":            # metadata (``x.device``)
            return out
        if not self._muted:
            self._tally(func, args, kwargs, out)
        self._track(out)
        return out

    def _tally(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        moved = 0
        if not outs or func.is_view or packet in _NO_TRAFFIC:
            pass
        elif packet in _GATHER:
            moved = nbytes(*ins[1:]) + 2 * nbytes(*outs)
        elif packet in _SCATTER:
            moved = nbytes(*ins[1:]) + nbytes(ins[-1])
        else:
            moved = nbytes(*ins, *outs)
        if not (flops or moved):
            return
        kind = kind_of(ins[0].dtype) if ins else "fp32"
        self._add(self.by_op, str(packet), "calls", flops, moved)
        self._add_totals(flops, kind, moved)

    def _follows(self, dev) -> bool:
        """Whether the peak follows ``dev`` (``cuda`` means any card's
        index, as tensors report ``cuda:0``)."""
        want = self.device
        return want is None or (dev.type == want.type and (
            want.index is None or dev.index == want.index))

    def hold(self, *trees) -> None:
        """Storages that exist before the step (its arguments): an op
        that returns one of them in place allocates nothing."""
        for t in _tensors(trees):
            st = t.untyped_storage()
            if id(st) not in self._live:
                self._live[id(st)] = 0
                weakref.finalize(st, self._free, id(st))

    def _track(self, out) -> None:
        for t in _tensors(out):
            if not self._follows(t.device):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            size = st.nbytes()
            self._live[key] = size
            self.live_bytes += size
            if not self._muted:
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------------ results
    def aggregate(self) -> dict:
        """The totals, under ``hlo_parse.aggregate``'s names where they
        mean something on one card (``link_bytes`` stands for its
        collective wire bytes)."""
        return {
            "flops_per_device": sum(self.flops_by_kind.values()),
            "flops_by_kind": dict(self.flops_by_kind),
            "hbm_bytes_per_device": self.hbm_bytes,
            "link_bytes": self.link_bytes,
            "peak_new_bytes": self.peak_bytes,
            "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())},
            "by_kernel": {k: dict(v)
                          for k, v in sorted(self.by_kernel.items())},
        }


def active() -> Counter | None:
    return _ACTIVE[-1] if _ACTIVE else None


class kernel:
    """``with kernel(name, work):`` around a kernel wrapper's dispatch.
    With a counter active, records one launch of ``name`` with
    ``work()`` = (flops, bytes, kind) and mutes the aten ops inside; with
    none, does nothing (``work`` is not called)."""

    __slots__ = ("name", "work", "counter")

    def __init__(self, name: str, work):
        self.name = name
        self.work = work
        self.counter = None

    def __enter__(self):
        c = active()
        if c is not None and not c._muted:
            c.record_kernel(self.name, *self.work())
            c._muted += 1
            self.counter = c
        return self

    def __exit__(self, *exc):
        if self.counter is not None:
            self.counter._muted -= 1
            self.counter = None
        return False


def trips(k: int):
    """``range(k)`` for a loop whose trips do the same work on inputs of
    one shape. Under a counter with ``fold_loops`` on fake tensors it
    yields 0 alone and counts that trip ``k`` times; the values it leaves
    are then those of one trip, which a fake run does not have anyway."""
    c = active()
    if c is None or not c.fold_loops or k <= 1 or not fake_mode_active():
        yield from range(k)
        return
    with c.scaled(k):
        yield 0
