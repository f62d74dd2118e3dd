"""Training steps of the reference: the loss's gradient, global-norm
clipping and AdamW with decoupled weight decay, all in fp32 (the fp32
parameters are their own master copy).

    g = clip(grad loss, max_norm)
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p = p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
"""
from __future__ import annotations

import torch

from perfbench.lib.tree import leaves, rebuild


def norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def steps(model, params, batches, cfg, opt: dict, precision="fp32"):
    """Run ``len(batches)`` steps from ``params`` (fp32). Returns each
    step's loss, each leaf's norm of the first clipped gradient and of the
    parameters' change over all the steps, by leaf path."""
    paths = [p for p, _ in leaves(params)]
    start = [t for _, t in leaves(params)]
    cur = [t.clone() for t in start]
    m = [torch.zeros_like(t) for t in start]
    v = [torch.zeros_like(t) for t in start]
    b1, b2 = opt["beta1"], opt["beta2"]
    out = {"loss": [], "grad": None}
    for k, (tokens, targets) in enumerate(batches):
        diff = [t.detach().requires_grad_(True) for t in cur]
        tree = rebuild(params, dict(zip(paths, diff)))
        with torch.enable_grad():
            loss = model.loss(tree, tokens, targets, cfg, precision)
            grads = torch.autograd.grad(loss, diff)
        out["loss"].append(float(loss.detach()))
        total = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = min(1.0, opt["grad_clip"] / max(float(total), 1e-9))
        grads = [g * scale for g in grads]
        if k == 0:
            out["grad"] = dict(zip(paths, norms(grads)))
        t = k + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = b1 * m[i] + (1.0 - b1) * g
                v[i] = b2 * v[i] + (1.0 - b2) * g.square()
                upd = (m[i] / c1) / (torch.sqrt(v[i] / c2) + opt["eps"])
                cur[i] = cur[i] - opt["learning_rate"] * (
                    upd + opt["weight_decay"] * cur[i])
        del grads, diff, tree
    out["change"] = dict(zip(paths, norms(c - s for c, s in zip(cur, start))))
    return out
