"""Queue-based pipeline parallelism — the paper's chain topology — on the
emulated PE axis.

The conv2d evaluation (Table III) splits 256 PEs into k independent chains,
trading peak throughput (chain heads become mover PEs) against transient
fill/drain time and stall propagation. ``pipelined`` is GPipe-style
fill-drain scheduling with one hop per tick over open chains
(``topology.chains``): stages = chain PEs, microbatches = the systolic
pulse, the fill/drain bubble = the chain transient, and ``n_chains``
independent pipelines work on disjoint microbatch slices.

The bubble fraction is (S-1)/(M+S-1) for S stages and M microbatches per
chain (``bubble_fraction``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import queues
from repro_torch.core.queues import table_cache
from repro_torch.core.topology import chains


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe fill/drain bubble = the paper's chain transient time."""
    return (n_stages - 1) / (n_stages - 1 + max(n_microbatches, 1))


@table_cache(maxsize=64)
def index_vector(values: tuple, device) -> torch.Tensor:
    """An int32 index vector, cached per device: a host-to-device copy per
    tick would stall the stream."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _take(params, idx):
    return None if params is None else params.index_select(0, idx)


def pipelined(stage_fn: Callable, n_pe: int, n_microbatches: int,
              mode: str = "qlr", n_chains: int = 1):
    """Build a pipelined apply over ``n_pe`` PEs: PE i runs stage
    (i mod n_stages) of chain (i div n_stages), n_stages = n_pe / n_chains.
    Chains process disjoint microbatch slices.

    ``stage_fn(stage_params, x, stage_idx) -> y`` runs all PEs at once,
    each at its own stage: x and y are ``[P, ...]`` (the queue element with
    a leading PE dim), stage_idx is ``[P]`` int32 and stage_params the rows
    of the parameters for those stages (or None).

    Returns fn(stage_params [n_stages, ...] or None, xs [M, ...]) -> ys
    [M, ...]. Per tick: every chain head pops its next microbatch from the
    input stream (the mover PE's shared-memory load; its hop delivered
    zeros), all PEs run their stage, the slots of stages with no
    microbatch this tick (the bubble) are zeroed, each chain's last stage
    stores its finished microbatch, and everything hops one step down the
    chains. ``stage_fn``'s output may be zeroed in place.

    ``baseline`` is the shared-memory form: no hops, each stage in turn
    over all M microbatches, n_stages calls of ``stage_fn``. Every mode
    gives identical values.
    """
    queues.check_mode(mode, baseline=True)
    if n_pe % n_chains or n_microbatches % n_chains:
        raise ValueError(f"{n_chains} chains must divide {n_pe} PEs and "
                         f"{n_microbatches} microbatches")
    n_stages = n_pe // n_chains
    m = n_microbatches // n_chains
    topo = chains("pe", n_pe, n_chains)
    n_ticks = m + n_stages - 1

    def run(stage_params, xs):
        if xs.shape[0] != n_microbatches:
            raise ValueError(f"expected {n_microbatches} microbatches, got "
                             f"{xs.shape[0]}")
        dev, rest = xs.device, tuple(xs.shape[1:])
        if mode == "baseline":
            y = xs
            for s in range(n_stages):
                idx = index_vector((s,) * n_microbatches, dev)
                y = stage_fn(_take(stage_params, idx), y, idx)
            return y
        stage_idx = index_vector(tuple(i % n_stages for i in range(n_pe)),
                                 dev)
        sp = _take(stage_params, stage_idx)
        xs_c = xs.reshape(n_chains, m, *rest)
        out = torch.zeros_like(xs)
        out_c = out.view(n_chains, m, *rest)
        buf = xs.new_zeros((n_pe, *rest))
        for t in range(n_ticks):
            if t < m:                      # heads pop microbatch t
                buf.view(n_chains, n_stages, *rest)[:, 0] = xs_c[:, t]
            y = stage_fn(sp, buf, stage_idx).contiguous()
            # stage s holds microbatch t - s: active for lo <= s <= hi
            lo, hi = max(0, t - m + 1), min(n_stages - 1, t)
            y_c = y.view(n_chains, n_stages, *rest)
            if lo > 0:
                y_c[:, :lo] = 0
            if hi < n_stages - 1:
                y_c[:, hi + 1:] = 0
            if hi == n_stages - 1:         # the last stages store
                out_c[:, t - hi] = y_c[:, -1]
            buf = queues.hop(topo, y, mode)
        return out

    return run
