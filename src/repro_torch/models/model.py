"""Unified model interface: ``build_model(cfg, n_pe) -> model``.

The dense and moe families (``TransformerLM``: ``init``, ``prefill``,
``loss``, ``init_cache``, ``cache_axes``, ``prefill_into_cache``,
``decode_step``), the ssm family (``MambaLM``) and the hybrid family
(``ZambaLM``: the same without ``prefill_into_cache``) are ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba import MambaLM, ZambaLM


def build_model(cfg: ModelConfig, n_pe: int = 0):
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg, n_pe=n_pe)
    if cfg.family == "ssm":
        if n_pe:
            raise NotImplementedError("MambaLM has no ring path (n_pe=0)")
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, n_pe=n_pe)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
