"""Unified model interface: ``build_model(cfg, n_pe) -> model``.

The dense, moe and vlm families (``TransformerLM``, GQA or MLA: ``init``,
``prefill``, ``loss``, ``init_cache``, ``cache_axes``,
``prefill_into_cache`` (GQA only), ``decode_step``), the ssm family
(``MambaLM``), the hybrid family (``ZambaLM``) and the encdec family
(``WhisperModel``: the same without ``prefill_into_cache``, plus
``encode``, ``decode_stack`` and ``fill_cross_cache``) are ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba import MambaLM, ZambaLM


def build_model(cfg: ModelConfig, n_pe: int = 0):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, n_pe=n_pe)
    if cfg.family == "encdec":
        return WhisperModel(cfg, n_pe=n_pe)
    if cfg.family == "ssm":
        if n_pe:
            raise NotImplementedError("MambaLM has no ring path (n_pe=0)")
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, n_pe=n_pe)
    raise ValueError(f"unknown family {cfg.family!r}")
