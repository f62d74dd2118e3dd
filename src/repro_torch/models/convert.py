"""Parameters and train states between the reference's layout and the
port's.

The reference keeps a tree whose ``layers`` leaves are stacked along a
leading layer dimension (``models/common.split_tree`` of its ``init``),
and an MoE model's ``first_k_dense`` leading dense layers in a second
stack, ``dense_layers``; the port keeps one list of per-layer dicts, the
dense layers first (dense: ``{norm1, norm2, attn, mlp}``; MoE: ``moe`` in
place of ``mlp``; Mamba2: ``{norm, mixer}``). A Zamba2 tree keeps its
``shared`` block unstacked, and its stacks ``adapters`` [n_super],
``mamba`` [n_super, inner] and ``tail`` [n_tail] become a list, a list of
lists and a list. A VLM's ``projector`` is unstacked in both packages.
A Whisper tree keeps ``embed``, the untied ``head``, ``enc_norm``,
``dec_norm`` and ``dec_pos`` unstacked, and its stacks ``enc_layers`` and
``dec_layers`` become two lists (it has no ``final_norm``). MLA's
attention leaves (``kv_norm`` 1-D) need nothing of their own. A
non-parametric norm is an empty dict in both packages, and is carried as
one. ``params_from_reference``
takes that tree with numpy leaves (``np.asarray`` of each value, bfloat16
included) so both packages compute the same function in the tests.
``state_from_reference`` / ``state_to_reference`` carry a whole train
state, ``{"params", "opt": {"m", "v", "master", "step"}}``, whose
optimizer trees mirror the parameter tree in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.common import pdtype, resolve_device

FP32_LEAVES = ("A_log", "D", "dt_bias", "router")


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
    """The first array of a tree, depth first, past empty dicts (a
    non-parametric norm's); None if it holds none."""
    if not isinstance(tree, dict):
        return tree
    for v in tree.values():
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


# Zamba2's stacks and their depth (leading stacked dimensions)
HYBRID_STACKS = {"adapters": 1, "mamba": 2, "tail": 1}
# Whisper's layer stacks, each one list in the port
ENCDEC_STACKS = ("enc_layers", "dec_layers")
# subtrees that neither package stacks
UNSTACKED = ("embed", "final_norm", "head", "shared", "projector",
             "enc_norm", "dec_norm", "dec_pos")


def _from_reference(tree, dt, dev):
    """A parameter-shaped reference tree -> the port's layout; leaves take
    ``dt`` except ``FP32_LEAVES``."""

    def convert(tree, index=None, name=""):
        if isinstance(tree, dict):
            return {k: convert(v, index, k) for k, v in tree.items()}
        return _tensor(_at(tree, index),
                       torch.float32 if name in FP32_LEAVES else dt, dev)

    def stack(group, depth=1):
        if group not in tree:
            return []
        dims = np.asarray(_first_leaf(tree[group])).shape[:depth]
        if depth == 1:
            return [convert(tree[group], i) for i in range(dims[0])]
        return [[convert(tree[group], (i, j)) for j in range(dims[1])]
                for i in range(dims[0])]

    out = {k: convert(tree[k], name=k) for k in UNSTACKED if k in tree}
    out.setdefault("head", {})
    if "shared" in tree:
        out.update({g: stack(g, depth) for g, depth in HYBRID_STACKS.items()
                    if g in tree})
    elif "enc_layers" in tree:
        out.update({g: stack(g) for g in ENCDEC_STACKS})
    else:
        out["layers"] = stack("dense_layers") + stack("layers")
    return out


def layer_groups(layers) -> list[tuple[str, int]]:
    """(the reference's stack, index in it) of each of the port's layers:
    where MoE layers follow dense ones, the dense ones are
    ``dense_layers``; otherwise every layer is in ``layers``."""
    n_dense = (sum("moe" not in lp for lp in layers)
               if any("moe" in lp for lp in layers) else 0)
    return [("dense_layers", i) if i < n_dense else ("layers", i - n_dense)
            for i in range(len(layers))]


def params_from_reference(tree, cfg: ModelConfig, device="cuda"):
    """Reference value tree (numpy leaves) -> the port's parameters. Every
    leaf takes the parameter dtype except those the reference keeps fp32
    whatever it is (``FP32_LEAVES``: Mamba2's ``A_log``, ``D``,
    ``dt_bias``; the MoE ``router``)."""
    return _from_reference(tree, pdtype(cfg), resolve_device(device))


def state_from_reference(tree, cfg: ModelConfig, tcfg: TrainConfig,
                         device="cuda"):
    """Reference train state (numpy leaves) -> the port's: parameters in
    the parameter dtype, ``m``, ``v`` and ``master`` (when
    ``tcfg.use_master_weights``) in fp32, ``step`` an int32 scalar."""
    dev = resolve_device(device)
    ropt = tree["opt"]
    opt = {"m": _from_reference(ropt["m"], torch.float32, dev),
           "v": _from_reference(ropt["v"], torch.float32, dev),
           "step": torch.tensor(int(np.asarray(ropt["step"])),
                                dtype=torch.int32, device=dev)}
    if tcfg.use_master_weights:
        opt["master"] = _from_reference(ropt["master"], torch.float32, dev)
    return {"params": params_from_reference(tree["params"], cfg, dev),
            "opt": opt}


def _zip_map(trees, fn):
    """Map ``fn`` over the leaves of same-shaped dict trees, zipped."""
    if isinstance(trees[0], dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in trees[0]}
    return fn(*trees)


def _as_np(t):
    return t.detach().float().cpu().numpy()


def _stack(items):
    """A list (or list of lists) of same-shaped trees -> one tree of
    float32 numpy arrays stacked along the list's dimensions."""
    if isinstance(items[0], list):
        items = [_stack(x) for x in items]
        return _zip_map(items, lambda *ls: np.stack(ls))
    return _zip_map(items, lambda *ls: np.stack([_as_np(t) for t in ls]))


def params_to_reference(params):
    """The port's parameters -> the reference's layout, float32 numpy."""
    out = {k: _map(params[k], _as_np) for k in UNSTACKED if k in params}
    if "shared" in params:
        out.update({g: _stack(params[g]) for g in HYBRID_STACKS
                    if g in params})
        return out
    if "enc_layers" in params:
        out.update({g: _stack(params[g]) for g in ENCDEC_STACKS})
        return out
    groups = [g for g, _ in layer_groups(params["layers"])]
    for group in dict.fromkeys(groups):
        out[group] = _stack([lp for lp, g in zip(params["layers"], groups)
                             if g == group])
    return out


def state_to_reference(state):
    """The port's train state -> the reference's layout: float32 numpy
    trees and an int32 ``step``."""
    opt = {k: params_to_reference(v) for k, v in state["opt"].items()
           if k != "step"}
    opt["step"] = np.asarray(int(state["opt"]["step"]), np.int32)
    return {"params": params_to_reference(state["params"]), "opt": opt}
