"""Timed trials, the port of ``repro/autotune/measure.py``.

``time_fn`` is the best-of-N wall-clock timer of the tuner. The port runs
every trial eagerly under ``torch.no_grad()`` (the reference jits each
trial; the port has no compiled path), and where the output lives on a
CUDA device each call is bracketed by ``torch.cuda.synchronize()`` (the
reference's ``jax.block_until_ready``). ``measure_plan`` adds the
secondary objective: the link bytes one call moves, from
``obs/linkstats``; among plans whose times are within noise of each other,
the one moving fewer bytes over the queues wins.

Every timed trial bumps a module counter, so tests (and ``chip_smoke.py``
phase 14) can prove that a cache hit ran no measurement.
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs import linkstats
from repro_torch.train.optimizer import tree_leaves

# count of timed trials since reset: the zero-remeasure witness
_TRIALS = 0


def reset_trials() -> None:
    global _TRIALS
    _TRIALS = 0


def trial_count() -> int:
    return _TRIALS


def _call(fn, args):
    """One eager call, returned once the device holds its output: every
    CUDA device an output tensor lives on is synchronized."""
    with torch.no_grad():
        out = fn(*args)
    for dev in {t.device for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Best-of-``iters`` wall microseconds for ``fn(*args)``.

    ``warmup`` (at least 1) unmeasured calls come first: on the card the
    first call builds the kernel libraries with ``nvcc`` and sets their
    launch attributes, which no timed call may include."""
    global _TRIALS
    if warmup < 1:
        raise ValueError(f"time_fn: warmup must be >= 1, got {warmup}")
    for _ in range(warmup):
        _call(fn, args)
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        _call(fn, args)
        best = min(best, time.perf_counter() - t0)
    _TRIALS += 1
    return best * 1e6


def link_bytes(fn, *args) -> float:
    """Total queue bytes one call moves: hop payloads plus multicast loads
    (``payload_bytes + mcast_bytes`` of one call under a linkstats scope).

    The reference sums the ``as_dict()`` keys that start with ``"bytes"``,
    which no key does, so it always returns 0.0; the port sums the two
    byte counters its docstring names. 0.0 means the call moved nothing
    over the links (pure-local compute)."""
    with linkstats.collect(1) as sc:
        _call(fn, args)
    return float(sc.stats.payload_bytes + sc.stats.mcast_bytes)


def measure_plan(build, plan, *, warmup: int = 1, iters: int = 3,
                 with_bytes: bool = True) -> dict:
    """Measure one plan. ``build(plan) -> (fn, args)``, ``fn`` an eager
    callable.

    Returns {"us": best-of wall us, "bytes": link bytes}, or
    {"us": inf, "error": ...} when the plan fails to build or run, so a
    sweep ranks it last; a caller that needs every plan timed checks for
    ``"error"``.
    """
    try:
        fn, args = build(plan)
        us = time_fn(fn, *args, warmup=warmup, iters=iters)
        out = {"us": us}
        if with_bytes:
            out["bytes"] = link_bytes(fn, *args)
        return out
    except Exception as e:  # inapplicable plan: rank last, keep sweeping
        return {"us": float("inf"), "error": f"{type(e).__name__}: {e}"}
