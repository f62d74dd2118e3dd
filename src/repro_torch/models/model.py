"""Unified model interface: ``build_model(cfg, n_pe) -> model``.

The dense, moe and vlm families (``TransformerLM``, GQA or MLA: ``init``,
``prefill``, ``loss``, ``init_cache``, ``cache_axes``,
``prefill_into_cache`` (GQA only), ``decode_step``), the ssm family
(``MambaLM``), the hybrid family (``ZambaLM``), the port's zamba2 family
(``Zamba2LM``: ``init``, ``prefill``, ``loss``) and the encdec family
(``WhisperModel``: the same without ``prefill_into_cache``, plus
``encode``, ``decode_stack`` and ``fill_cross_cache``) are ported, with
``input_specs(cfg, shape)``: the stand-ins and logical axes of every
model input of a dry-run cell (no allocation).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import adtype
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba import MambaLM, Zamba2LM, ZambaLM


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
    if cfg.family == "zamba2":
        return Zamba2LM(cfg, n_pe=n_pe)
    raise ValueError(f"unknown family {cfg.family!r}")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta"):
    """Stand-ins for every model input of this shape cell: tensors on
    ``device`` with no data (``meta`` tensors, PyTorch's
    ``ShapeDtypeStruct``; under a ``FakeTensorMode``, fake tensors of any
    device). Returns (specs, logical_axes), with the reference's names,
    shapes, types and axes. ``decode`` kinds describe only the per-step
    token batch and the continuous-batching row mask, the step the serving
    engine drives; the cache comes from ``init_cache``."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":
        specs = {"tokens": spec((b, 1), torch.int32),
                 "active": spec((b,), torch.bool)}
        axes = {"tokens": ("cache_batch", None), "active": ("cache_batch",)}
        return specs, axes

    specs = {"tokens": spec((b, s), torch.int32)}
    axes = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        specs["targets"] = spec((b, s), torch.int32)
        axes["targets"] = ("batch", "seq")
    if cfg.family == "encdec":
        specs["frames"] = spec((b, cfg.enc_frames, cfg.d_model), adtype(cfg))
        axes["frames"] = ("batch", "frames", None)
    if cfg.family == "vlm":
        specs["patch_embeds"] = spec((b, cfg.num_patches, cfg.vit_dim),
                                     adtype(cfg))
        axes["patch_embeds"] = ("batch", "patches", None)
    return specs, axes
