"""Parameters between the reference's layout and the port's.

The reference keeps a tree whose ``layers`` leaves are stacked along a
leading layer dimension (``models/common.split_tree`` of its ``init``);
the port keeps a list of per-layer dicts (dense: ``{norm1, norm2, attn,
mlp}``; Mamba2: ``{norm, mixer}``). ``params_from_reference`` takes that
tree with numpy leaves (``np.asarray`` of each value, bfloat16
included) so both packages compute the same function in the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import pdtype, resolve_device

FP32_LEAVES = ("A_log", "D", "dt_bias")


def _tensor(a, dtype, device) -> torch.Tensor:
    # numpy has no bfloat16 of its own: widen to float32 (exact), then
    # round to the parameter dtype (exact for bf16 sources)
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _at(a, index):
    """Layer ``index`` of a stacked leaf (the whole leaf for None)."""
    return a if index is None else np.asarray(a)[index]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_reference(tree, cfg: ModelConfig, device="cuda"):
    """Reference value tree (numpy leaves) -> the port's parameters. Every
    leaf takes the parameter dtype except those the reference keeps fp32
    whatever it is (``FP32_LEAVES``: Mamba2's ``A_log``, ``D``,
    ``dt_bias``)."""
    dev = resolve_device(device)
    dt = pdtype(cfg)

    def convert(tree, index=None, name=""):
        if isinstance(tree, dict):
            return {k: convert(v, index, k) for k, v in tree.items()}
        return _tensor(_at(tree, index),
                       torch.float32 if name in FP32_LEAVES else dt, dev)

    layers = tree["layers"]
    n_layers = np.asarray(_first_leaf(layers)).shape[0]
    return {
        "embed": convert(tree["embed"]),
        "final_norm": convert(tree["final_norm"]),
        "head": convert(tree.get("head", {})),
        "layers": [convert(layers, i) for i in range(n_layers)],
    }


def _zip_map(trees, fn):
    """Map ``fn`` over the leaves of same-shaped dict trees, zipped."""
    if isinstance(trees[0], dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in trees[0]}
    return fn(*trees)


def params_to_reference(params):
    """The port's parameters -> the reference's layout, float32 numpy."""
    as_np = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    return {
        "embed": _map(params["embed"], as_np),
        "final_norm": _map(params["final_norm"], as_np),
        "head": _map(params["head"], as_np),
        "layers": _zip_map(params["layers"],
                           lambda *ls: np.stack([as_np(t) for t in ls])),
    }
