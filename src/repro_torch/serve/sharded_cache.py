"""Decode backends: the device-side halves of the serving engine.

* :class:`DecodeBackend` — one ``model.decode_step`` per tick over the
  slot batch, no ring: the dense LM, or Mamba2 (whose prompts stream
  through the decode step, having no block prefill).
* :class:`RingShardedBackend` — the hybrid systolic layout on one card:
  the model runs over an emulated ring of ``n_pe`` PEs with
  ``cfg.systolic_mode`` set to a link mode, so decode streams each row's
  query around the resident cache shards (``ring_decode_attention``) and
  block prefill streams K/V blocks through ``ring_attention`` and its
  projections through the collective-matmul rings.

Both expose the same surface — ``step``, ``free_slot``,
``prefill_len``/``prefill`` — so the scheduler cannot tell them apart.
The cache is one tensor per field, updated in place by the model.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import NullTracer


def _to_device(tree, device):
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

    def free_slot(self, slot: int) -> None:
        """Zero a freed slot's cache rows so the next occupant decodes
        bit-identically to a fresh engine."""
        for leaf in self.cache["layers"].values():
            leaf[:, slot] = 0

    @property
    def supports_prefill(self) -> bool:
        """Block prefill needs the model's ``prefill_into_cache`` (Mamba2
        has none: its prompts stream through the decode step)."""
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
    ``n_pe`` PEs, decode queries streamed over the links in ``mode``."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 n_pe: int, mode: str = "qlr", device="cuda"):
        self.n_pe = n_pe
        self.mode = mode
        self.name = f"ring-{mode}"
        super().__init__(replace(cfg, systolic_mode=mode), scfg, params,
                         device=device, n_pe=n_pe)
