"""Plan selection API: cache-first lookup, online sweeps, config threading;
the port of ``repro/autotune/api.py``.

``best_plan`` is the single entry point. Model code calls it cache-only
(``allow_tune=False``: a miss means the config defaults stand), while a
caller with a builder (``chip_smoke.py`` phase 14) lets ``tune`` sweep the
applicable plans.

The reference keys on its mesh; the port's rings are emulated in one
process, so the ring size ``n_pe`` takes the mesh's place and the key's
last part is ``model=<n_pe>``. A reference key with a ``data`` axis is
never matched.

``tuned_cfg`` is the ``Config.autotune`` gate used by
``models/attention.gqa_forward``/``gqa_decode`` and
``models/moe.apply_moe``: look the op up, and when a plan is cached,
rewrite the systolic config fields via ``apply_plan``.
``serve.sharded_cache.RingShardedBackend(plan=...)`` threads a plan into
the serving stack the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.autotune import measure
from repro_torch.autotune.cache import (
    TuneCache,
    check_writable,
    default_path,
)
from repro_torch.autotune.space import Plan, candidates

# relative wall-clock band treated as measurement noise: plans inside it
# tie on time and are split by link bytes (the utilization objective)
NOISE = 0.03

_CACHE: Optional[TuneCache] = None


def mesh_key(n_pe: int) -> tuple:
    """Ring size -> hashable ((axis, size),) cache-key component."""
    return (("model", int(n_pe)),)


def global_cache(path: Optional[str] = None) -> TuneCache:
    """The process-wide cache (loaded lazily from ``default_path()``)."""
    global _CACHE
    if _CACHE is None or (path is not None and path != _CACHE.path):
        _CACHE = TuneCache(path or default_path())
    return _CACHE


def set_cache_path(path: Optional[str]) -> TuneCache:
    """Point the global cache at ``path`` (reloads; tests use tmp files)."""
    global _CACHE
    _CACHE = TuneCache(path)
    return _CACHE


def best_plan(op: str, shape, dtype, n_pe: int, *,
              cache: Optional[TuneCache] = None, allow_tune: bool = False,
              build=None, plans: Optional[list] = None, warmup: int = 1,
              iters: int = 3) -> Optional[Plan]:
    """Measured plan for (op, shape, dtype, ring of ``n_pe``), or None.

    Ladder: exact cache hit (zero re-measurement), else nearest-shape hit
    (also zero re-measurement), else, only when ``allow_tune`` and a
    ``build`` callback are given, an online sweep that persists its
    winner. Cache-only callers (model code) get None on a total miss and
    keep their config defaults.
    """
    cache = cache if cache is not None else global_cache()
    plan = cache.lookup(op, shape, str(dtype), mesh_key(n_pe))
    if plan is not None:
        return plan
    if not allow_tune or build is None:
        return None
    plan, _ = tune(op, shape, dtype, n_pe, build, cache=cache, plans=plans,
                   warmup=warmup, iters=iters)
    return plan


def tune(op: str, shape, dtype, n_pe: int, build, *,
         cache: Optional[TuneCache] = None, plans: Optional[list] = None,
         warmup: int = 1, iters: int = 3, save: bool = True,
         noise: float = NOISE, device: Optional[str] = None):
    """Sweep the applicable plans for ``op`` and persist the winner.

    ``build(plan) -> (fn, args)`` with ``fn`` an eager callable. Primary
    objective: best-of wall time. Secondary: among plans within ``noise``
    of the fastest, fewest link bytes wins. ``device`` names what the
    trials run on (a card's name and power limit); the cache refuses to
    mix it with entries of another device. With ``save``, the cache's
    file must not be the committed one (``cache.check_writable``), which
    is checked before any trial. Returns
    (winner, {plan.label(): {"us", "bytes", ...}}).
    """
    cache = cache if cache is not None else global_cache()
    if save:
        check_writable(cache.path or default_path())
    if plans is None:
        plans = candidates(op, n_pe)
    results = {}
    for plan in plans:
        results[plan.label()] = dict(measure.measure_plan(
            build, plan, warmup=warmup, iters=iters), plan=plan)
    timed = [r for r in results.values() if r["us"] != float("inf")]
    if not timed:
        raise RuntimeError(f"every candidate plan failed for {op} {shape}: "
                           f"{[r.get('error') for r in results.values()]}")
    best_us = min(r["us"] for r in timed)
    near = [r for r in timed if r["us"] <= best_us * (1.0 + noise)]
    winner = min(near, key=lambda r: (r.get("bytes", 0.0), r["us"]))["plan"]
    win = results[winner.label()]
    cache.put(op, shape, str(dtype), mesh_key(n_pe), winner, device=device,
              us=win["us"], bytes=win.get("bytes", 0.0))
    if save:
        cache.save()
    for r in results.values():
        r.pop("plan", None)
    return winner, results


def apply_plan(cfg, plan: Plan):
    """Rewrite a ModelConfig's systolic fields (mode, topology, block) from
    a plan. The port's rings always run their kernels, so a
    ``use_kernel=False`` plan (the reference's jnp consume) is refused."""
    if not plan.use_kernel:
        raise ValueError(f"plan {plan.label()} asks for the plain consume "
                         f"(use_kernel=False); the port's rings always run "
                         f"their kernels")
    return dataclasses.replace(
        cfg, systolic_mode=plan.mode, systolic_topology=plan.topology,
        kernel_block=plan.block)


def tuned_cfg(cfg, op: str, shape, n_pe: int):
    """The ``Config.autotune`` gate: cache-only lookup, defaults on miss.

    Called from model forward paths (``models/attention._tuned``); never
    measures. The one place that reads ``cfg.autotune``."""
    if not getattr(cfg, "autotune", False):
        return cfg
    plan = best_plan(op, tuple(int(s) for s in shape), cfg.dtype, n_pe,
                     allow_tune=False)
    return apply_plan(cfg, plan) if plan is not None else cfg
