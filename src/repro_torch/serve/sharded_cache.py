"""Decode backends: the device-side halves of the serving engine.

* :class:`DecodeBackend` — one ``model.decode_step`` per tick over the
  slot batch, no ring: the dense LM, or Mamba2 and Zamba2 (whose prompts
  stream through the decode step, having no block prefill).
* :class:`RingShardedBackend` — the hybrid systolic layout on one card:
  the model runs over an emulated ring of ``n_pe`` PEs with
  ``cfg.systolic_mode`` set to a link mode, so decode streams each row's
  query around the resident cache shards (``ring_decode_attention``) and
  block prefill streams K/V blocks through ``ring_attention`` and its
  projections through the collective-matmul rings.

Both expose the same surface — ``step``, ``free_slot``,
``prefill_len``/``prefill``, ``snapshot_cache``/``adopt_cache``,
``link_health``, ``link_stats``, ``set_telemetry`` — so the scheduler and
the health monitor cannot tell them apart. The cache is a tree of
tensors, updated in place by the model; so where the reference's monitor
keeps a reference to its immutable cache as a free snapshot, the port's
``snapshot_cache`` clones every leaf, and ``adopt_cache`` copies a
snapshot back into the backend's own cache. ``free_slot`` finds a slot's
row in every leaf by the ``cache_batch`` axis of the model's
``cache_axes()``, as the reference does, never by guessing a dimension.

Robustness and telemetry (``serve/health.py`` rides on them):

* ``RingShardedBackend(..., checked=True)`` runs each step under the
  host-armed fault spec (``core/faults.py``) and, after it, a checked
  link **probe**: a canary ``[n_pe, 4]`` fp32 payload streamed once round
  the same ring in the same mode with the tag/checksum sidecar. It shares
  the decode stream's (hop, PE) coordinates, so a fault that poisons the
  decode math also trips the probe; ``link_health()`` holds its per-class
  error counts for the tick. The probe launches no kernel.
* ``telemetry=True`` arms a ``linkstats`` scope around every step and
  prefill; ``set_telemetry`` flips collection at run time and
  ``link_stats()`` returns the accumulated queue-traffic totals.

Neither changes a value or a kernel launch of the step itself.
"""
from __future__ import annotations

import contextlib
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import faults, queues, topology
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.obs import linkstats
from repro_torch.obs.trace import NullTracer
from repro_torch.train.optimizer import tree_map


def _to_device(tree, device):
    """Tensors already on ``device`` are kept, not copied: a backend
    rebuilt on the mode ladder shares the engine's parameters."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class DecodeBackend:
    """Dense backend: one decode step over the slot batch, per-slot cache
    rows zeroed on reuse."""

    name = "dense"

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 device="cuda", n_pe: int = 0):
        self.tracer = NullTracer()        # engine swaps in its own
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, n_pe=n_pe)
        self.max_batch = scfg.max_batch
        self.max_seq = scfg.max_seq_len
        self.params = _to_device(params, self.device)
        self.cache = self.model.init_cache(self.max_batch, self.max_seq,
                                           self.device)

    @torch.inference_mode()
    def step(self, tokens: np.ndarray, active: np.ndarray):
        """One decode tick for the whole slot batch -> logits [B, V]."""
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(active, device=self.device))
        return logits

    @torch.no_grad()
    def free_slot(self, slot: int) -> None:
        """Zero a freed slot's cache rows so the next occupant decodes
        bit-identically to a fresh engine: in every leaf, the row at its
        ``cache_batch`` axis (leaves without one are shared by all slots
        and kept)."""
        def zero(leaf, axes):
            if axes and "cache_batch" in axes:
                leaf[(slice(None),) * axes.index("cache_batch") + (slot,)] = 0
        tree_map(zero, self.cache, self.model.cache_axes())

    @torch.no_grad()
    def snapshot_cache(self):
        """A copy of the cache (every leaf cloned): the model writes the
        cache in place, so a rollback needs its own copy."""
        return tree_map(torch.clone, self.cache)

    @torch.no_grad()
    def adopt_cache(self, cache) -> None:
        """Take over a cache snapshot (a rollback, or another backend's on
        the mode ladder): copy it into this backend's own cache, leaving
        the snapshot itself untouched."""
        tree_map(lambda mine, theirs: mine.copy_(theirs), self.cache, cache)

    def link_health(self) -> dict:
        """Per-class link error counts of the last step's probe (empty for
        backends without systolic links)."""
        return {}

    def link_stats(self) -> dict:
        """Accumulated queue-traffic totals (empty without telemetry: the
        dense path has no links to count)."""
        return {}

    def set_telemetry(self, on: bool) -> None:
        """Toggle link telemetry collection (no-op without links)."""

    @property
    def supports_prefill(self) -> bool:
        """Block prefill needs the model's ``prefill_into_cache`` and a
        full GQA cache (Mamba2, Zamba2 and Whisper have none, and MLA's
        cache holds latents: their prompts stream through the decode
        step)."""
        return (self.scfg.prefill_chunk > 0
                and hasattr(self.model, "prefill_into_cache")
                and self.cfg.attention_type == "gqa"
                and not self.cfg.sliding_window)

    def prefill_len(self, prompt_len: int) -> int:
        """How many leading prompt tokens to block-prefill (the rest stream
        through the decode step; at least the final prompt token always
        streams, so sampling stays uniform)."""
        if not self.supports_prefill:
            return 0
        chunk = min(self.scfg.prefill_chunk, self.max_seq)
        return max(min(prompt_len - 1, chunk), 0)

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: np.ndarray) -> None:
        """Block-prefill ``prompt`` (already clipped to ``prefill_len``)
        into ``slot``: one full-sequence forward over a fixed-size chunk
        writes its K/V into the slot's cache rows and sets the position."""
        chunk = min(self.scfg.prefill_chunk, self.max_seq)
        buf = np.zeros(chunk, np.int32)
        buf[:len(prompt)] = prompt
        _, self.cache = self.model.prefill_into_cache(
            self.params, self.cache, torch.as_tensor(buf, device=self.device),
            slot, len(prompt))


class RingShardedBackend(DecodeBackend):
    """Ring-sharded backend: resident cache shards on an emulated ring of
    ``n_pe`` PEs, decode queries streamed over the links in ``mode``.

    ``checked=True`` arms the robustness layer: each step runs under the
    host-armed fault spec, and a checked canary probe runs after it,
    surfacing link health. ``telemetry=True`` counts the queue traffic of
    every step and prefill.

    ``plan`` (an ``autotune.Plan``) threads a measured tuning plan into
    the backend: it overrides ``mode`` and rewrites the config's systolic
    fields (mode, topology, block) before the model is built: the serving
    end of the Config.autotune path.

    The reference's ``param_axes`` is a mesh-sharding rule and has no
    meaning on one card.
    """

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 n_pe: int, mode: str = "qlr", checked: bool = False,
                 telemetry: bool = False, device="cuda", plan=None):
        if plan is not None:
            mode = plan.mode
        self.n_pe = n_pe
        self.mode = mode
        self.plan = plan
        self.checked = checked
        self.telemetry = telemetry
        self.telemetry_on = telemetry
        self.stats_total = linkstats.zeros()
        self.last_health: dict = {}
        self.name = f"ring-{mode}" + ("+checked" if checked else "") \
            + ("+tuned" if plan is not None else "")
        cfg = replace(cfg, systolic_mode=mode)
        if plan is not None:
            from repro_torch.autotune.api import apply_plan
            cfg = apply_plan(cfg, plan)
        super().__init__(cfg, scfg, params, device=device, n_pe=n_pe)
        self._probe_topo = None
        if checked and mode in queues.MODES:
            # the canary rides the schedule the decode stream hops (grids
            # fall back to the ring the decode dual actually uses)
            self._probe_topo = topology.resolve_safe(
                self.cfg.systolic_topology, "model", n_pe, cycle_only=True)
            self._probe_payload = torch.arange(
                n_pe * 4, dtype=torch.float32,
                device=self.device).reshape(n_pe, 4) + 1.0

    @contextlib.contextmanager
    def _observed(self, vec=None):
        """The step's or prefill's context: the fault spec (checked steps)
        and the telemetry scope, folded into the totals on exit."""
        with contextlib.ExitStack() as st:
            if vec is not None:
                st.enter_context(faults.scope(vec))
            sc = st.enter_context(linkstats.collect(self.telemetry_on)) \
                if self.telemetry else None
            yield
        if sc is not None:
            self.stats_total = self.stats_total.add(sc.stats)

    def step(self, tokens: np.ndarray, active: np.ndarray):
        vec = faults.injected_vec() if self.checked else None
        with self._observed(vec):
            logits = super().step(tokens, active)
        if self.checked:
            with self.tracer.span("probe", cat="serve"):
                self.last_health = self._probe_links(vec)
        return logits

    def prefill(self, slot: int, prompt: np.ndarray) -> None:
        with self._observed():
            super().prefill(slot, prompt)

    # --------------------------------------------------------- robustness
    @torch.inference_mode()
    def _probe_links(self, vec) -> dict:
        """One checked circuit of the canary under the step's fault spec;
        any armed fault at (hop t, PE d) trips a sidecar check here."""
        if self._probe_topo is None:
            return {}
        with faults.scope(vec), linkstats.mute():    # control traffic
            _, _, health = queues.stream(
                self._probe_topo, self._probe_payload, self.n_pe,
                lambda s, b, t: s + b.sum(dim=1),
                torch.zeros(self.n_pe, device=self.device), self.mode,
                checked=True)
        errs = health.sum(dim=(0, 1)).tolist()
        return {"tag_errors": int(errs[0]), "csum_errors": int(errs[1])}

    def link_health(self) -> dict:
        return dict(self.last_health)

    # ---------------------------------------------------------- telemetry
    def link_stats(self) -> dict:
        return self.stats_total.as_dict() if self.telemetry else {}

    def set_telemetry(self, on: bool) -> None:
        """Flip run-time collection; requires telemetry=True at build."""
        self.telemetry_on = bool(on) and self.telemetry
