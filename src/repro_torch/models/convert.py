"""Parameters between the reference's layout and the port's.

The reference keeps a tree whose ``layers`` leaves are stacked along a
leading layer dimension (``models/common.split_tree`` of its ``init``);
the port keeps a list of per-layer dicts. ``params_from_reference`` takes
that tree with numpy leaves (``np.asarray`` of each value, bfloat16
included) so both packages compute the same function in the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import pdtype, resolve_device


def _tensor(a, dtype, device) -> torch.Tensor:
    # numpy has no bfloat16 of its own: widen to float32 (exact), then
    # round to the parameter dtype (exact for bf16 sources)
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree, cfg: ModelConfig, device="cuda"):
    """Reference value tree (numpy leaves) -> the port's parameters."""
    dev = resolve_device(device)
    dt = pdtype(cfg)
    convert = lambda a: _tensor(a, dt, dev)  # noqa: E731
    layers = tree["layers"]
    n_layers = np.asarray(layers["norm1"]["scale"]).shape[0]
    return {
        "embed": _map(tree["embed"], convert),
        "final_norm": _map(tree["final_norm"], convert),
        "head": _map(tree.get("head", {}), convert),
        "layers": [_map(layers, lambda a, i=i: _tensor(np.asarray(a)[i], dt,
                                                       dev))
                   for i in range(n_layers)],
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
