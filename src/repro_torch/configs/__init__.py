"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``,
and the dry run's grid: ``get_shape(name)`` / ``iter_cells()``. ``ARCHS``
is the reference's registry; the port's own configurations
(``PORT_ARCHS``: zamba2-7b) are found by name too but stay out of the
dry run's grid, which is held against the reference's."""
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
    zamba2_7b,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
    apply_overrides,
    config_summary,
    shape_applicable,
)

__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "ModelConfig", "ServeConfig",
           "ShapeConfig", "TrainConfig", "apply_overrides", "config_summary",
           "get_config", "get_shape", "get_smoke_config", "iter_cells",
           "shape_applicable"]

_MODULES = {          # the reference registry's order
    "granite-34b": granite_34b,
    "qwen3-14b": qwen3_14b,
    "qwen3-0.6b": qwen3_0p6b,
    "olmo-1b": olmo_1b,
    "whisper-tiny": whisper_tiny,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mamba2-1.3b": mamba2_1p3b,
    "zamba2-1.2b": zamba2_1p2b,
    "internvl2-1b": internvl2_1b,
}

ARCHS: tuple[str, ...] = tuple(_MODULES)
_PORT_MODULES = {"zamba2-7b": zamba2_7b}
PORT_ARCHS: tuple[str, ...] = tuple(_PORT_MODULES)


def _module(arch: str):
    mod = _MODULES.get(arch) or _PORT_MODULES.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{', '.join(ARCHS + PORT_ARCHS)}")
    return mod


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: "
                       f"{', '.join(SHAPES)}")
    return SHAPES[name]


def iter_cells():
    """Yield every applicable (arch, shape) dry-run cell."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = shape_applicable(cfg, shape)
            if ok:
                yield arch, shape.name
