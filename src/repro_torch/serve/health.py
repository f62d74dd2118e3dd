"""Self-healing layer for the serving engine, the port of the reference's
``repro/serve/health.py``.

The :class:`HealthMonitor` wraps each engine tick in a guard:

1. snapshot the scheduler's mutable tick state and the cache. The
   reference's cache is an immutable pytree, so its snapshot is a
   reference; the port's model writes the cache in place, so the snapshot
   is a copy of every leaf (``backend.snapshot_cache()``), paid only by a
   monitored engine;
2. plan + run the backend step, then judge it on three signals: the
   checked-link probe (``backend.link_health()``), the wall-clock deadline
   (read after ``torch.cuda.synchronize()``, where the reference blocks
   until the logits are ready), and row-wise logit finiteness
   (``core/guard.py``);
3. a **link or deadline** fault indicts the *transport*, not any one
   request: roll the scheduler back, rebuild the backend one rung down
   the mode ladder on the snapshotted cache, and retry the tick (bounded
   by ``max_retries``; a persistent fault cascades through the ladder
   within a single guarded step until it reaches a hop-free rung);
4. **non-finite logits without a link fault** indict the poisoned rows
   themselves: roll back scheduler *and* cache, evict those requests
   terminally (status ``error``), zero their cache rows, and yield the
   tick;
5. only a tick that passes every check commits sampled tokens, so a
   rolled-back tick leaves zero trace: recovery is bitwise-identical to
   a run that was born on the degraded rung.

The ladder orders rungs by how much systolic machinery they trust:
``qlr`` -> ``xqueue`` -> ``sw`` -> ``baseline`` (all-gather: no per-hop
links left to fault) -> ``dense`` (no ring at all). A rebuilt backend
shares the engine's parameters (no second copy), adopts the snapshot, and
carries the telemetry totals over.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import guard
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend

MODE_LADDER = ("qlr", "xqueue", "sw", "baseline", "dense")


class FatalFaultError(RuntimeError):
    """The monitor ran out of ladder rungs or retries; every in-flight
    request has been marked ``failed``."""

    def __init__(self, msg: str, failed: list):
        super().__init__(msg)
        self.failed = failed


@dataclass(frozen=True)
class HealthConfig:
    deadline_s: float = 0.0     # per-step wall-clock budget (0 = off)
    max_retries: int = 5        # degrade attempts within one guarded step
    backoff_s: float = 0.0      # host sleep between degrade attempts


@dataclass(frozen=True)
class HealthEvent:
    tick: int
    kind: str                   # link_fault | deadline | nonfinite | degrade
    detail: str
    mode: str                   # backend name when the event fired


class HealthMonitor:
    """Per-tick guard owned by a :class:`~repro_torch.serve.engine.
    ServeEngine` (built automatically when the engine gets a
    ``HealthConfig``)."""

    def __init__(self, engine, hcfg: HealthConfig | None = None):
        self.eng = engine
        self.hcfg = hcfg or HealthConfig()
        self.events: list[HealthEvent] = []
        self.tick = 0
        self._sync_rung_gauge()

    # ------------------------------------------------------------- ladder
    def _rung(self) -> str:
        b = self.eng.backend
        return b.mode if isinstance(b, RingShardedBackend) else "dense"

    def _sync_rung_gauge(self) -> None:
        self.eng.metrics.gauge(
            "repro_mode_rung",
            "ladder position, 0=qlr .. 4=dense").set(
            MODE_LADDER.index(self._rung()))

    def _note(self, kind: str, detail: str) -> None:
        self.events.append(
            HealthEvent(self.tick, kind, detail, self.eng.backend.name))
        self.eng.tracer.instant(kind, cat="serve",
                                args={"tick": self.tick, "detail": detail})
        self.eng.metrics.counter(f"repro_health_{kind}_total",
                                 f"health events of kind {kind}").inc()

    def _degrade(self, snap_cache) -> bool:
        """Rebuild the backend one rung down the ladder on the snapshotted
        cache. Returns False when already on the last rung."""
        eng, old = self.eng, self.eng.backend
        idx = MODE_LADDER.index(self._rung())
        if idx + 1 >= len(MODE_LADDER):
            return False
        nxt = MODE_LADDER[idx + 1]
        if nxt == "dense":
            new = DecodeBackend(eng.cfg, eng.scfg, eng._params,
                                device=old.device)
        else:
            new = RingShardedBackend(
                eng.cfg, eng.scfg, eng._params, old.n_pe, mode=nxt,
                checked=True, telemetry=old.telemetry, device=old.device)
            new.stats_total = old.stats_total      # telemetry survives
        new.adopt_cache(snap_cache)
        self._note("degrade", f"{old.name} -> {new.name}")
        eng.metrics.counter("repro_degradations_total",
                            "mode-ladder rungs stepped down").inc()
        new.tracer = eng.tracer
        eng.backend = new
        self._sync_rung_gauge()
        return True

    def force_degrade(self) -> str:
        """Step down one rung unconditionally (ops control, and how the
        chaos test builds its matched-ladder clean reference run).
        Returns the new backend name."""
        if not self._degrade(self.eng.backend.cache):
            raise FatalFaultError(
                "force_degrade: already on the last ladder rung", [])
        return self.eng.backend.name

    def _fatal(self, why: str):
        failed = self.eng.sched.fail_all(why)
        raise FatalFaultError(why, failed)

    # -------------------------------------------------------------- guard
    def guarded_step(self) -> None:
        eng, hcfg = self.eng, self.hcfg
        self.tick += 1
        snap_sched = eng.sched.snapshot()
        snap_cache = eng.backend.snapshot_cache()

        for _ in range(hcfg.max_retries + 1):
            tokens, active, sampling = eng.sched.plan()
            t0 = time.perf_counter()
            with eng.tracer.span("decode", cat="serve"):
                logits = eng.backend.step(tokens, active)
                if logits.is_cuda:
                    torch.cuda.synchronize(logits.device)
            elapsed = time.perf_counter() - t0

            health = eng.backend.link_health()
            link_bad = sum(health.values()) > 0
            deadline_bad = 0.0 < hcfg.deadline_s < elapsed

            if link_bad or deadline_bad:
                # transport fault: no request is at fault — rewind the
                # tick and retry it one rung down
                why = (f"link probe {health}" if link_bad
                       else f"step took {elapsed:.3f}s > "
                            f"deadline {hcfg.deadline_s:.3f}s")
                self._note("link_fault" if link_bad else "deadline", why)
                eng.tracer.instant("rollback", cat="serve",
                                   args={"tick": self.tick, "why": why})
                eng.metrics.counter("repro_rollbacks_total",
                                    "ticks rolled back and retried").inc()
                eng.sched.restore(snap_sched)
                if not self._degrade(snap_cache):
                    self._fatal(f"mode ladder exhausted after {why}")
                if hcfg.backoff_s > 0:
                    time.sleep(hcfg.backoff_s)
                continue

            bad_rows = np.asarray(active) & ~guard.row_finite(logits)
            if bad_rows.any():
                # numeric poisoning with healthy links: indict the rows,
                # not the transport — evict them and keep the rung
                eng.metrics.counter("repro_rollbacks_total",
                                    "ticks rolled back and retried").inc()
                eng.sched.restore(snap_sched)
                eng.backend.adopt_cache(snap_cache)
                for slot in np.nonzero(bad_rows)[0]:
                    req = eng.sched.evict(int(slot),
                                          reason="non-finite logits")
                    self._note("nonfinite",
                               f"evicted rid={req.rid} slot={int(slot)}")
                    eng.backend.free_slot(int(slot))
                return

            eng._sample_and_commit(logits, sampling)
            return

        self._fatal(f"fault persisted through {hcfg.max_retries} retries")
