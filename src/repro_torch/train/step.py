"""Train step builder: the function the launcher calls once per step.

Mirrors ``repro/train/step.py``'s training half. There is no mesh on one
card: the model's systolic paths run on an emulated ring of ``n_pe`` PEs
(``build_model(cfg, n_pe)``), and its ring hops launch the CUDA kernels.
The reference's sharded-shape helpers (``state_shapes``, ``batch_shapes``,
``cache_shapes``, ``params_shapes``) serve its multi-pod dry run and have
no one-card counterpart.

Distributed-optimization features, all config-driven as in the reference:
  * microbatch gradient accumulation with fp32 accumulators,
  * gradient compression (bf16 / fp8-sim) and decompression,
  * global-norm clipping, AdamW with fp32 master weights,
  * activation remat via cfg.remat (applied inside the model),
  * the paper's systolic ring matmuls and ring attention via
    cfg.systolic_mode and ``n_pe``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import build_model
from repro_torch.train import optimizer as opt


def init_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
               device="cuda"):
    """Random parameters from ``seed`` and a fresh optimizer state."""
    params = build_model(cfg).init(seed=seed, device=device)
    return {"params": params, "opt": opt.init_opt_state(params, tcfg)}


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the grads
    have the parameters' dtypes, as ``jax.value_and_grad`` gives them."""
    leaves = opt.tree_leaves(params)
    diff = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(diff)
    with torch.enable_grad():
        loss, metrics = model.loss(opt.tree_map(lambda _: next(it), params),
                                   batch)
        got = torch.autograd.grad(loss, diff, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(got, diff))
    grads = opt.tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    n_pe: int = 0) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: loss and grads,
    then compress, decompress, clip and AdamW, in the reference's order.
    ``batch`` holds ``tokens`` and ``targets`` [B,S] (and optionally a
    ``mask``) on the state's device; metrics are 0-d tensors ``loss``,
    ``grad_norm``, ``lr``, ``ce`` and ``aux``."""
    model = build_model(cfg, n_pe=n_pe)

    def train_step(state, batch):
        params = state["params"]
        if tcfg.microbatches > 1:
            grads, (loss, metrics) = _accumulated_grads(model, params,
                                                        batch, tcfg)
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        grads = opt.compress_gradients(grads, tcfg.grad_compression)
        grads = opt.decompress_gradients(grads)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt, lr = opt.adamw_update(grads, state["opt"],
                                                   params, tcfg)
        out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                       **metrics}
        return {"params": new_params, "opt": new_opt}, out_metrics

    return train_step


def _accumulated_grads(model, params, batch, tcfg: TrainConfig):
    """Microbatched gradient accumulation with fp32 accumulators; returns
    (grads, (mean loss, the last microbatch's metrics))."""
    k = tcfg.microbatches

    def micro(x, i):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not divide into {k} "
                             "microbatches")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))[i]

    grads = opt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=opt.tree_leaves(params)[0].device)
    metrics = {}
    for i in range(k):
        mb = {name: micro(x, i) for name, x in batch.items()}
        loss, metrics, g = value_and_grad(model, params, mb)
        grads = opt.tree_map(lambda a, gi: a + gi.float() / k, grads, g)
        loss_acc = loss_acc + loss / k
    return grads, (loss_acc, metrics)
