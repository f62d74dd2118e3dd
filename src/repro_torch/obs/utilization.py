"""Utilization accounting: measured LinkStats + FLOP counts + energy
models → per-(mode, workload) compute-unit utilization % and modeled
GOPS/W — the analogue of the paper's Figs. 9–15. A copy of the
reference's ``repro/obs/utilization.py`` over the port's counters.

The paper's §VI-C steady-state model charges every issue slot to one of
MACs, queue operations, or shared-memory loads:

    util = MACs / (MACs + queue_ops + loads)          (sw / xqueue)
    util = MACs / max(MACs + loads, stall + loads)    (qlr)

where QLRs elide the queue instructions entirely, leaving only a link-
bandwidth stall floor of ``words / 4`` (4 words per cycle through the
queue registers). The 73% headline is this model's ceiling for the
compute-bound DSP kernels; software FIFOs land near 10x down because
each word costs ~9 bookkeeping slots (head/tail updates, boundary
checks — paper Fig. 3).

Here the *traffic terms are measured, not estimated*: ``payload_bytes``
and ``mcast_bytes`` come from a :class:`~repro_torch.obs.linkstats.LinkStats`
scope around the actual computation, so the report reflects what
the schedule really moved (including skew hops, sidecars excluded).
Only the per-word instruction costs are model constants:

    sw      SW_OPS_PER_WORD issue slots per word, each direction
    xqueue  1 slot per word, each direction (single-instruction q.push/pop)
    qlr     0 slots; stall floor = words / QLR_WORDS_PER_CYCLE
    baseline queue-free; mcast words count as shared-memory loads

FLOPs come from the caller — the model's own count for model workloads,
or the kernel's 2*M*N*K for benchmarks. Energy reuses
``core.energy.account`` with link/remote bytes from the same counters.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import energy

# per-word instruction-cost constants of the paper's execution model
SW_OPS_PER_WORD = 9          # software FIFO bookkeeping (paper Fig. 3)
XQ_OPS_PER_WORD = 1          # Xqueue: single-instruction push / pop
QLR_WORDS_PER_CYCLE = 4      # QLR link bandwidth -> stall floor words/4
WORD_BYTES = 4               # the paper's 32-bit words


@dataclass
class UtilReport:
    """One (mode, workload) cell of the utilization/energy table."""
    mode: str
    flops: float             # total useful FLOPs of the workload
    macs: float              # flops / 2 — the issue-slot unit of the model
    queue_words: float       # words moved through queues (measured)
    load_words: float        # words read via shared-memory multicast (measured)
    queue_ops: float         # issue slots charged to queue instructions
    stall: float             # qlr bandwidth-stall slots
    utilization: float       # compute-unit utilization, 0..1
    energy: energy.EnergyReport
    errors: int = 0          # checked-link tag+csum error total

    @property
    def gops_per_w(self) -> float:
        return self.energy.gops_per_w

    def summary(self) -> str:
        return (f"mode={self.mode} util={100 * self.utilization:.1f}% "
                f"[modeled] GOPS/W={self.gops_per_w:.0f} "
                f"(macs={self.macs:.3g} qwords={self.queue_words:.3g} "
                f"loads={self.load_words:.3g} errs={self.errors})")


def _stats_dict(stats) -> dict:
    return stats if isinstance(stats, dict) else stats.as_dict()


def report(stats, *, flops: float, mode: str,
           model: energy.EnergyModel = energy.MEMPOOL,
           local_bytes: float = 0.0, word_bytes: int = WORD_BYTES,
           sw_ops_per_word: int = SW_OPS_PER_WORD) -> UtilReport:
    """Build one utilization/energy cell from measured link telemetry.

    stats: a LinkStats (or its ``as_dict()``) collected around the
    workload — totals over the PEs. flops: the workload's useful FLOPs (same
    scope: every PE, whole run). local_bytes: optional resident-operand
    traffic for the energy model's local-access term.
    """
    d = _stats_dict(stats)
    macs = flops / 2.0
    queue_words = d["payload_bytes"] / word_bytes
    load_words = d["mcast_bytes"] / word_bytes
    stall = 0.0

    if mode == "qlr":
        queue_ops = 0.0
        stall = queue_words / QLR_WORDS_PER_CYCLE
        util = macs / max(macs + load_words, stall + load_words, 1.0)
    elif mode == "xqueue":
        queue_ops = 2.0 * XQ_OPS_PER_WORD * queue_words   # push + pop
        util = macs / max(macs + queue_ops + load_words, 1.0)
    elif mode == "sw":
        queue_ops = 2.0 * sw_ops_per_word * queue_words
        util = macs / max(macs + queue_ops + load_words, 1.0)
    else:                                                 # baseline / dense
        queue_ops = 0.0
        util = macs / max(macs + load_words, 1.0)

    rep = energy.account(
        model, flops=flops, local_bytes=local_bytes,
        remote_bytes=d["mcast_bytes"], link_bytes=d["payload_bytes"],
        instr_overhead_ops=queue_ops)
    return UtilReport(
        mode=mode, flops=flops, macs=macs, queue_words=queue_words,
        load_words=load_words, queue_ops=queue_ops, stall=stall,
        utilization=util, energy=rep,
        errors=int(d.get("tag_errors", 0)) + int(d.get("csum_errors", 0)))


def table(reports) -> str:
    """Fixed-width text table over UtilReports (benchmark output)."""
    head = (f"{'mode':<10} {'util%':>7} {'GOPS/W*':>8} {'qwords':>12} "
            f"{'loads':>12} {'errs':>5}")
    rows = [head, "-" * len(head)]
    for r in reports:
        rows.append(f"{r.mode:<10} {100 * r.utilization:>7.1f} "
                    f"{r.gops_per_w:>8.0f} {r.queue_words:>12.3g} "
                    f"{r.load_words:>12.3g} {r.errors:>5d}")
    rows.append("* modeled (core/energy.py MEMPOOL calibration)")
    return "\n".join(rows)
