"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    granite_34b,
    internvl2_1b,
    mamba2_1p3b,
    mixtral_8x22b,
    olmo_1b,
    qwen3_0p6b,
    qwen3_14b,
    whisper_tiny,
    zamba2_1p2b,
)
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
    "olmo-1b": olmo_1b,
    "qwen3-14b": qwen3_14b,
    "granite-34b": granite_34b,
    "zamba2-1.2b": zamba2_1p2b,
    "internvl2-1b": internvl2_1b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "whisper-tiny": whisper_tiny,
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
