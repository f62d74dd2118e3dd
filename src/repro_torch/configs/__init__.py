"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``."""
from __future__ import annotations

from repro_torch.configs import mamba2_1p3b, mixtral_8x22b, qwen3_0p6b
from repro_torch.configs.base import (
    ModelConfig,
    ServeConfig,
    TrainConfig,
    apply_overrides,
)

__all__ = ["ARCHS", "ModelConfig", "ServeConfig", "TrainConfig",
           "apply_overrides", "get_config", "get_smoke_config"]

_MODULES = {
    "qwen3-0.6b": qwen3_0p6b,
    "mamba2-1.3b": mamba2_1p3b,
    "mixtral-8x22b": mixtral_8x22b,
}

ARCHS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {', '.join(ARCHS)}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {', '.join(ARCHS)}")
    return _MODULES[arch].SMOKE
