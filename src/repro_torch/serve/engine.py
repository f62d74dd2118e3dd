"""Batched serving engine with continuous batching.

A thin composition, as in the reference:

* :class:`repro_torch.serve.scheduler.Scheduler` — host-side continuous
  batching: slot admission/eviction, prompt streaming, per-slot budgets.
* a decode backend (:mod:`repro_torch.serve.sharded_cache`) — parameters,
  cache and the step. The default is the dense backend; pass
  ``RingShardedBackend(cfg, scfg, params, n_pe, mode)`` to serve from a KV
  cache sharded over an emulated systolic ring.
* optionally a :class:`repro_torch.serve.health.HealthMonitor` (pass a
  ``HealthConfig`` as ``health``) — per-tick link-probe / finite / deadline
  checks with snapshot rollback, poisoned-request eviction and mode-ladder
  degradation.

Each tick plans a fixed ``max_batch``-row token batch (the ``active`` mask
keeps idle slots' caches frozen), runs one backend step, samples, and
commits. The engine owns a metrics :class:`~repro_torch.obs.metrics.
Registry` and an optional :class:`~repro_torch.obs.trace.Tracer` that
spans each tick's phases (prefill / decode / sample; the backend adds
probe, the monitor rollback / degrade / evict marks);
``export_observability`` writes both, the link telemetry folded in.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NullTracer, Tracer
from repro_torch.serve.sample import sample
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401 (re-export)
from repro_torch.serve.sharded_cache import DecodeBackend


class TicksExhaustedError(RuntimeError):
    """run() hit max_ticks with requests still in flight; they have been
    marked ``failed`` (terminal), not silently dropped."""

    def __init__(self, msg: str, failed: list):
        super().__init__(msg)
        self.failed = failed


class ServeEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 backend: DecodeBackend | None = None, health=None,
                 metrics: obs_metrics.Registry | None = None,
                 tracer: Tracer | None = None, device="cuda"):
        self.cfg = cfg
        self.scfg = scfg
        self._params = params                  # kept for backend rebuilds
        self.metrics = metrics if metrics is not None \
            else obs_metrics.Registry()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.backend = backend if backend is not None \
            else DecodeBackend(cfg, scfg, params, device=device)
        self.backend.tracer = self.tracer
        self.sched = Scheduler(scfg.max_batch, scfg.max_seq_len,
                               bos_token=scfg.bos_token,
                               eos_token=scfg.eos_token,
                               metrics=self.metrics)
        self.generator = torch.Generator(device=self.backend.device)
        self.generator.manual_seed(scfg.seed)
        self._tick = 0
        self.monitor = None
        if health is not None:
            from repro_torch.serve.health import HealthMonitor
            self.monitor = HealthMonitor(self, health)

    @property
    def max_batch(self) -> int:
        return self.scfg.max_batch

    @property
    def max_seq(self) -> int:
        return self.scfg.max_seq_len

    @property
    def pending(self) -> list:
        return self.sched.pending

    @property
    def params(self):
        return self.backend.params

    @property
    def cache(self):
        return self.backend.cache

    @property
    def model(self):
        return self.backend.model

    # ------------------------------------------------------------- client
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        """Queue a request; returns its rid. Empty prompts are seeded with
        ``scfg.bos_token``; ``max_new_tokens`` is clipped to the sequence
        budget and over-long prompts raise ValueError."""
        return self.sched.submit(prompt, max_new_tokens).rid

    # ---------------------------------------------------------- scheduler
    def _admit(self):
        for slot, req in self.sched.admit():
            self.backend.free_slot(slot)
            n_block = self.backend.prefill_len(len(req.prompt))
            if n_block > 0:
                with self.tracer.span("prefill", cat="serve",
                                      args={"slot": slot, "rid": req.rid,
                                            "tokens": n_block}), \
                        self.metrics.histogram(
                            "repro_prefill_latency_seconds",
                            "block-prefill wall time").time():
                    self.backend.prefill(slot, req.prompt[:n_block])
                self.sched.note_prefilled(slot, n_block)
                self.metrics.counter(
                    "repro_prefill_tokens_total",
                    "prompt tokens absorbed by block prefill").inc(n_block)

    def _sample_and_commit(self, logits, sampling):
        with self.tracer.span("sample", cat="serve"):
            next_tok = sample(logits, self.generator, self.scfg.temperature,
                              self.scfg.top_k).cpu().numpy()
            self.sched.commit(sampling, next_tok)
        self.metrics.counter("repro_tokens_total",
                             "tokens sampled and committed").inc(
            int(np.sum(sampling)))

    def step(self):
        """One engine tick = one backend decode step for all slots (under
        the health monitor's guard when one is configured)."""
        self._tick += 1
        self.metrics.counter("repro_ticks_total", "engine ticks run").inc()
        with self.tracer.span("tick", cat="serve",
                              args={"tick": self._tick}), \
                self.metrics.histogram("repro_tick_latency_seconds",
                                       "whole-tick wall time").time():
            if self.monitor is not None:
                return self.monitor.guarded_step()
            tokens, active, sampling = self.sched.plan()
            with self.tracer.span("decode", cat="serve"):
                logits = self.backend.step(tokens, active)
            self._sample_and_commit(logits, sampling)

    def export_observability(self, metrics_json=None, metrics_prom=None,
                             trace_out=None) -> None:
        """Write metrics (JSON and/or Prometheus text) and the Chrome
        trace. Folds the backend's link telemetry into the registry as
        ``repro_link_<field>_total`` counters first, so snapshots are
        self-contained."""
        for k, v in self.backend.link_stats().items():
            c = self.metrics.counter(f"repro_link_{k}_total",
                                     "queue telemetry (LinkStats)")
            c.value = float(v)                 # totals, not deltas
        if metrics_json:
            self.metrics.dump_json(metrics_json)
        if metrics_prom:
            self.metrics.dump_prometheus(metrics_prom)
        if trace_out:
            self.tracer.dump(trace_out)

    def run(self, max_ticks: int = 10_000) -> int:
        """Drive until all submitted requests complete. Returns #ticks.

        If ``max_ticks`` is exhausted with work still in flight, the
        leftover requests are marked terminally ``failed`` and
        :class:`TicksExhaustedError` is raised. The engine's tracer is
        armed meanwhile (the port's program spans record into it)."""
        ticks = 0
        t0 = time.perf_counter()
        tok0 = self.metrics.counter("repro_tokens_total").value
        self.tracer.arm()
        try:
            while self.sched.busy and ticks < max_ticks:
                self._admit()
                self.step()
                ticks += 1
        finally:
            self.tracer.disarm()
        elapsed = time.perf_counter() - t0
        done_toks = self.metrics.counter("repro_tokens_total").value - tok0
        self.metrics.gauge(
            "repro_tokens_per_second",
            "committed tokens / wall time of the last run()").set(
            done_toks / elapsed if elapsed > 0 else 0.0)
        if self.sched.busy:
            failed = self.sched.fail_all(f"max_ticks={max_ticks} exhausted")
            raise TicksExhaustedError(
                f"{len(failed)} request(s) still in flight after "
                f"{max_ticks} ticks; marked failed", failed)
        return ticks
