"""Optimizer substrate: AdamW with decoupled weight decay, global-norm
clipping, warmup+cosine/linear schedules, optional fp32 master weights
over low-precision params, and gradient compression hooks.

Mirrors ``repro/train/optimizer.py`` function for function, as plain
functions on the port's parameter tree (nested dicts, with the layers as a
list of per-layer dicts). The optimizer state mirrors the parameter tree:
fp32 ``m``, ``v`` (and ``master``) and an int32 ``step``. Every function
returns new tensors and leaves its inputs as they were, as the
reference's functions do, except ``adamw_update``, which updates the
moments ``m`` and ``v`` in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig


def tree_map(f, *trees):
    """``f`` over the leaves of same-shaped trees of dicts, lists and
    tuples, zipped; the result has the first tree's structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def learning_rate(tcfg: TrainConfig, step) -> torch.Tensor:
    """The schedule's rate at ``step`` (int or tensor), an fp32 scalar."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    if tcfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - tcfg.warmup_steps)
                           / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                           0.0, 1.0)
        if tcfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif tcfg.schedule == "linear":
            decay = 1.0 - frac
        else:
            raise ValueError(tcfg.schedule)
    return tcfg.learning_rate * warm * decay


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def compress_gradients(grads, method: str):
    """Gradient compression for the cross-pod all-reduce.

    bf16    — cast to bf16 before the reduction (2x wire traffic saving).
    fp8sim  — simulate fp8-e4m3 quantization (value-faithful emulation:
              scale to e4m3 dynamic range, round via a float8 cast).
    """
    if method == "none":
        return grads
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    if method == "fp8sim":
        def qd(g):
            g32 = g.float()
            amax = torch.clamp(torch.max(torch.abs(g32)), min=1e-12)
            scale = 448.0 / amax          # e4m3 max normal
            return (g32 * scale).to(torch.float8_e4m3fn).float() / scale
        return tree_map(qd, grads)
    raise ValueError(method)


def decompress_gradients(grads):
    return tree_map(lambda g: g.float(), grads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def init_opt_state(params, tcfg: TrainConfig):
    device = tree_leaves(params)[0].device
    state: dict[str, Any] = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tcfg.use_master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(grads, opt_state, params, tcfg: TrainConfig):
    """One AdamW step. grads fp32 (post-clip). Returns (params, opt_state,
    lr).

    The reference's arithmetic, leaf by leaf, with the moments ``m`` and
    ``v`` updated in place (as a donated buffer is): the returned state
    holds the same ``m``/``v`` tensors, and new ``master`` and param
    tensors, so a caller that keeps the masters or params it had still
    reads them unchanged. At its peak the step then holds one set of
    moments, not two (8 bytes a parameter less)."""
    step = opt_state["step"] + 1
    lr = learning_rate(tcfg, step)
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(g, m, v, p):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        p32 = p.float()
        update = (m / c1) / (torch.sqrt(v / c2) + tcfg.eps)
        return p32 - lr * (update + tcfg.weight_decay * p32)

    new_base = tree_map(upd, grads, opt_state["m"], opt_state["v"],
                        opt_state.get("master", params))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    if tcfg.use_master_weights:
        new_state["master"] = new_base
    new_params = tree_map(lambda b, p: b.to(p.dtype), new_base, params)
    return new_params, new_state, lr
