"""Search space: (link mode x topology x block x use_kernel) with
applicability gates, the port of ``repro/autotune/space.py``.

A Plan is the unit the cache stores and the models consume: four config
fields that together pick one point of the paper's design space (which
link emulation moves the operands, which permutation schedule the queues
are pointed at, and the tile of the per-hop consume). ``Plan`` and its
dict form are the reference's, so one cache file reads the same in both
packages.

Every ring hop of the port is one call of a kernel wrapper (the CUDA
kernel on the card), so ``candidates`` enumerates kernel plans only
(``kernels=(True,)``): a ``use_kernel=False`` plan would put the plain
version on the card's main path. For the same reason the ops whose plan
a model applies (``GATED_OPS``) get no ``baseline`` plan: in the port's
models a ``baseline`` config takes the dense path, which launches no
kernel, so such a plan would be timed on one path and run on another.
``DEFAULT_PLAN`` is the untuned point of a direct ring call,
``baseline/ring/k``; ``default_plan(op)`` is the one a sweep of ``op``
is held against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from repro_torch.core import topology as topo_lib

MODES = ("baseline", "sw", "xqueue", "qlr")
TOPOLOGIES = ("ring", "snake_fold", "torus2d", "cannon_grid")
# cycle schedules only: ops whose streamed element must return home
# (decode's stream_carry) or that place experts rather than sweep tiles
CYCLE_TOPOLOGIES = ("ring", "snake_fold")
BLOCKS = (0, 64, 128)

# ops the tuner knows; each maps to the topology family it can ride
OP_TOPOLOGIES = {
    "matmul": TOPOLOGIES,
    "attention": TOPOLOGIES,
    "moe": CYCLE_TOPOLOGIES,
    "decode": CYCLE_TOPOLOGIES,
    "serve": CYCLE_TOPOLOGIES,
}
# ops whose plan ``Config.autotune`` or ``RingShardedBackend(plan=)``
# applies to a model: link-mode plans only (see the module docstring)
GATED_OPS = ("attention", "decode", "moe", "serve")


@dataclass(frozen=True, order=True)
class Plan:
    """One tunable configuration: the four knobs a measured trial fixes."""
    mode: str = "qlr"
    topology: str = "ring"
    block: int = 0
    use_kernel: bool = False

    def to_dict(self) -> dict:
        return {"mode": self.mode, "topology": self.topology,
                "block": int(self.block), "use_kernel": bool(self.use_kernel)}

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        return cls(mode=d.get("mode", "qlr"),
                   topology=d.get("topology", "ring"),
                   block=int(d.get("block", 0)),
                   use_kernel=bool(d.get("use_kernel", False)))

    def label(self) -> str:
        k = f"k{self.block or ''}" if self.use_kernel else "jnp"
        return f"{self.mode}/{self.topology}/{k}"


DEFAULT_PLAN = Plan(mode="baseline", topology="ring", block=0,
                    use_kernel=True)
# the ring backend's own default (``RingShardedBackend(mode="qlr")``)
RING_DEFAULT_PLAN = Plan(mode="qlr", topology="ring", block=0,
                         use_kernel=True)


def default_plan(op: str) -> Plan:
    """The untuned plan a sweep of ``op`` is held against: the ring
    backend's default for a gated op, ``DEFAULT_PLAN`` otherwise."""
    return RING_DEFAULT_PLAN if op in GATED_OPS else DEFAULT_PLAN


def candidates(op: str, n_pe: int, *,
               modes: Iterable[str] = MODES,
               topologies: Optional[Iterable[str]] = None,
               blocks: Iterable[int] = (0,),
               kernels: Iterable[bool] = (True,)) -> list[Plan]:
    """Enumerate the applicable plans for ``op`` on a ring of ``n_pe``.

    Gates:
      * topology family per op (grids need a valid even fold; decode/serve
        and MoE ride cycle schedules only);
      * ``baseline`` multicasts: the topology axis collapses to "ring";
        a gated op (``GATED_OPS``) gets no ``baseline`` plan;
      * a block size only means something under ``use_kernel``.
    """
    if op not in OP_TOPOLOGIES:
        raise ValueError(f"unknown op {op!r}; expected one of "
                         f"{tuple(OP_TOPOLOGIES)}")
    topos = tuple(topologies) if topologies is not None else OP_TOPOLOGIES[op]
    plans = []
    seen = set()
    for mode in modes:
        for topo in topos:
            if mode == "baseline" and (topo != "ring" or op in GATED_OPS):
                continue
            base = topo.partition(":")[0]
            if base in ("torus2d", "cannon_grid") \
                    and not topo_lib.grid_ok(n_pe):
                continue
            for use_kernel in kernels:
                for block in (blocks if use_kernel else (0,)):
                    p = Plan(mode=mode, topology=topo, block=int(block),
                             use_kernel=bool(use_kernel))
                    if p not in seen:
                        seen.add(p)
                        plans.append(p)
    return plans
