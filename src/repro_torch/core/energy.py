"""Modeled energy accounting, copied from the reference's
``repro/core/energy.py`` (the port imports nothing of it). No power is
measured here: every output is a MODELED value, labeled as such wherever
printed.

``MEMPOOL`` reproduces the paper's *relative* energy story on its own
terms: 32-bit ops, local (same-tile) vs remote (cross-tile) memory access
energy with the paper's measured 2x ratio, interconnect share ~30% of
group power for memory-bound kernels. ``obs/utilization.py`` uses it for
GOPS/W-style figures comparable to the paper's Figs. 9-15.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyModel:
    name: str
    pj_per_flop: float          # functional unit energy per op
    pj_per_byte_local: float    # same-tile SPM access
    pj_per_byte_remote: float   # cross-tile access
    pj_per_byte_link: float     # systolic link hop
    pj_per_instr_overhead: float  # per-instruction control overhead (fetch/decode)


# Calibrated so the shared-memory matmul baseline lands near the paper's
# measured ~52% of power in the PEs and ~30% in the interconnect, and the
# QLR variants recover the reported 60-64% energy-efficiency gains.
MEMPOOL = EnergyModel(
    name="mempool-22fdx-32b",
    pj_per_flop=1.0,
    pj_per_byte_local=0.25,
    pj_per_byte_remote=0.5,      # paper: remote ~2x local energy
    pj_per_byte_link=0.25,       # queues live in local banks
    pj_per_instr_overhead=0.6,   # Snitch fetch/decode/issue share
)


@dataclass
class EnergyReport:
    total_pj: float
    pe_pj: float                # functional-unit (compute) energy
    mem_pj: float
    link_pj: float
    overhead_pj: float
    flops: float

    @property
    def pe_fraction(self) -> float:
        return self.pe_pj / max(self.total_pj, 1e-12)

    @property
    def gops_per_w(self) -> float:
        """ops / (pJ * 1e-12 J) => GOPS/W = flops / (total_pj * 1e-3)."""
        return self.flops / max(self.total_pj, 1e-12) * 1e3

    def summary(self) -> str:
        return (f"[modeled] GOPS/W={self.gops_per_w:.0f} "
                f"PE%={100 * self.pe_fraction:.0f} "
                f"(pe={self.pe_pj:.3g} mem={self.mem_pj:.3g} "
                f"link={self.link_pj:.3g} ovh={self.overhead_pj:.3g} pJ)")


def account(model: EnergyModel, *, flops: float, local_bytes: float = 0.0,
            remote_bytes: float = 0.0, link_bytes: float = 0.0,
            instr_overhead_ops: float = 0.0) -> EnergyReport:
    pe = flops * model.pj_per_flop
    mem = (local_bytes * model.pj_per_byte_local
           + remote_bytes * model.pj_per_byte_remote)
    link = link_bytes * model.pj_per_byte_link
    ovh = instr_overhead_ops * model.pj_per_instr_overhead
    return EnergyReport(
        total_pj=pe + mem + link + ovh, pe_pj=pe, mem_pj=mem, link_pj=link,
        overhead_pj=ovh, flops=flops)
