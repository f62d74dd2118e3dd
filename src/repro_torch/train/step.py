"""Train and serve step builders: the functions the launchers call once
per step, and the shape helpers of the dry run.

Mirrors ``repro/train/step.py``. There is no mesh on one card: the
model's systolic paths run on an emulated ring of ``n_pe`` PEs
(``build_model(cfg, n_pe)``), and its ring hops launch the CUDA kernels.
``make_prefill_step`` and ``make_serve_step`` are the steps of the
reference's prefill and decode cells. The shape helpers
(``params_shapes``, ``state_shapes``, ``batch_shapes``, ``cache_shapes``)
build their trees as ``FakeTensor``s on the requested device (shapes,
types, no allocation), under the dry run's ``FakeTensorMode`` when one is
active; where the reference returns logical axes they return
``input_specs``' and ``cache_axes()``. Parameter axes have no counterpart:
they only place tensors on a mesh.

Distributed-optimization features, all config-driven as in the reference:
  * microbatch gradient accumulation with fp32 accumulators,
  * gradient compression (bf16 / fp8-sim) and decompression,
  * global-norm clipping, AdamW with fp32 master weights,
  * activation remat via cfg.remat (applied inside the model),
  * the paper's systolic ring matmuls and ring attention via
    cfg.systolic_mode and ``n_pe``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.kernels._build import fake_mode_active
from repro_torch.models import build_model, input_specs
from repro_torch.obs import trace
from repro_torch.roofline import count
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
        with trace.span("train.forward"):
            loss, metrics = model.loss(
                opt.tree_map(lambda _: next(it), params), batch)
        with trace.span(trace.BACKWARD):
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
    ``grad_norm``, ``lr``, ``ce`` and ``aux``. AdamW's moments are updated
    in place: the state returned shares them with the state given."""
    model = build_model(cfg, n_pe=n_pe)

    def train_step(state, batch):
        with trace.span("train.step"):
            params = state["params"]
            if tcfg.microbatches > 1:
                grads, (loss, metrics) = _accumulated_grads(model, params,
                                                            batch, tcfg)
            else:
                loss, metrics, grads = value_and_grad(model, params, batch)
            with trace.span("train.optimizer"):
                grads = opt.compress_gradients(grads, tcfg.grad_compression)
                grads = opt.decompress_gradients(grads)
                grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
                new_params, new_opt, lr = opt.adamw_update(
                    grads, state["opt"], params, tcfg)
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
    for i in count.trips(k):
        mb = {name: micro(x, i) for name, x in batch.items()}
        loss, metrics, g = value_and_grad(model, params, mb)
        grads = opt.tree_map(lambda a, gi: a + gi.float() / k, grads, g)
        loss_acc = loss_acc + loss / k
    return grads, (loss_acc, metrics)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, n_pe: int = 0) -> Callable:
    """``prefill_step(params, batch) -> last-position logits [B, V]``:
    ``batch`` holds ``tokens`` [B,S] (and ``frames`` in the encdec family,
    optionally ``patch_embeds`` in the vlm family), as ``input_specs``
    describes it."""
    model = build_model(cfg, n_pe=n_pe)

    @torch.no_grad()
    def prefill_step(params, batch):
        with trace.span("prefill.step"):
            if cfg.family == "encdec":
                return model.prefill(params, batch)
            if cfg.family == "vlm":
                return model.prefill(params, batch["tokens"],
                                     batch.get("patch_embeds"))
            return model.prefill(params, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ModelConfig, n_pe: int = 0) -> Callable:
    """One decode token against the cache (the decode cells):
    ``serve_step(params, cache, tokens [B,1], active [B]) -> (logits,
    cache)``, with the continuous-batching ``active`` row mask the serving
    engine drives."""
    model = build_model(cfg, n_pe=n_pe)

    @torch.no_grad()
    def serve_step(params, cache, tokens, active):
        return model.decode_step(params, cache, tokens, active)

    return serve_step


# ---------------------------------------------------------------------------
# Shapes (the dry run)
# ---------------------------------------------------------------------------


def _fake():
    """The dry run's active ``FakeTensorMode``, or a new one."""
    return contextlib.nullcontext() if fake_mode_active() \
        else FakeTensorMode()


def _to(tree, device):
    return opt.tree_map(lambda t: t.to(device), tree)


def params_shapes(cfg: ModelConfig, device="cuda"):
    """The parameter tree as fake tensors on ``device``. The tree is built
    on the CPU (a ``cuda`` generator needs the card) and moved: a fake
    move allocates nothing."""
    with _fake():
        return _to(build_model(cfg).init(seed=0, device="cpu"), device)


def state_shapes(cfg: ModelConfig, tcfg: TrainConfig, device="cuda"):
    """The train state (parameters and optimizer state) as fake tensors on
    ``device``."""
    with _fake():
        return _to(init_state(cfg, tcfg, device="cpu"), device)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig, device="cuda"):
    """(the cell's inputs as fake tensors on ``device``, their logical
    axes)."""
    with _fake():
        return input_specs(cfg, shape, device=torch.device(device))


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig, device="cuda"):
    """(the decode cache of ``global_batch`` rows and ``seq_len``
    positions as fake tensors on ``device``, its ``cache_axes()``)."""
    model = build_model(cfg)
    with _fake():
        cache = _to(model.init_cache(shape.global_batch, shape.seq_len,
                                     device="cpu"), device)
    return cache, model.cache_axes()
