"""Unified model interface: ``build_model(cfg, n_pe) -> model``.

Only the dense family is ported; the model exposes ``init``, ``prefill``,
``init_cache``, ``prefill_into_cache`` and ``decode_step``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, n_pe: int = 0):
    if cfg.family == "dense":
        return TransformerLM(cfg, n_pe=n_pe)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
