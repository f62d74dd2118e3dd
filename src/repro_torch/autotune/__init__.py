"""repro_torch.autotune: measured (mode, topology, block) plan selection,
the port of ``repro/autotune``.

The paper's shared-memory-mapped queues make systolic topology
reconfiguration essentially free: re-pointing the queues is the cost of
switching a ring to a snake or a torus. This package treats that freedom
as a tuning axis: enumerate the applicable (link mode x topology x block)
plans for an op/shape (space.py), time them as eager trials with link
bytes as a secondary objective (measure.py), persist the winners keyed by
op/shape/dtype/ring (cache.py), and thread the chosen plan back into the
model and serving configs (api.py, ``Config.autotune``).

Inside the models the lookup is cache-only (exact key, else nearest
shape); sweeps run through ``tune`` (``chip_smoke.py`` phase 14 writes
the committed ``AUTOTUNE_CACHE_H100.json`` that way).
"""
from repro_torch.autotune.space import Plan, candidates
from repro_torch.autotune.cache import TuneCache, make_key
from repro_torch.autotune.api import (
    apply_plan,
    best_plan,
    global_cache,
    mesh_key,
    set_cache_path,
    tune,
    tuned_cfg,
)

__all__ = [
    "Plan", "candidates", "TuneCache", "make_key", "apply_plan",
    "best_plan", "global_cache", "mesh_key", "set_cache_path", "tune",
    "tuned_cfg",
]
