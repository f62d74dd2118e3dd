"""Mamba2 language model (arXiv:2405.21060), plain fp32.

A pre-norm residual stack of Mamba2 blocks between a token embedding and
a final RMSNorm, with the head tied to the embedding. A Mamba2 block:

    z, x, B, C, dt = split(in_proj(rmsnorm(u)))
    x, B, C = silu(causal depthwise conv(x, B, C) + bias)
    dt = softplus(dt + dt_bias); A = -exp(A_log)
    y = SSD(x, dt, A, B, C) + D x       (B, C shared by a group's heads)
    y = rmsnorm(y * silu(z), eps 1e-6) * norm_scale
    u = u + out_proj(y)

``cfg`` is the ``model`` group of a configuration's file; ``params`` the
benchmark's parameter tree in fp32, read by the port's leaf names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as ops

GATED_NORM_EPS = 1e-6


def mixer(p, h, cfg, precision):
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    hp = cfg["ssm_headdim"]
    nh = d_in // hp
    g, n = cfg["ssm_ngroups"], cfg["ssm_state"]
    bs, s = h.shape[:2]
    zxbcdt = ops.linear(h, p["w_in"], precision)
    z, x, b, c, dt = torch.split(zxbcdt, [d_in, d_in, g * n, g * n, nh], -1)
    xbc = F.silu(ops.causal_conv(torch.cat([x, b, c], -1), p["conv_w"],
                                 p["conv_b"]))
    x, b, c = torch.split(xbc, [d_in, g * n, g * n], -1)
    x = x.reshape(bs, s, nh, hp)
    heads = lambda t: t.reshape(bs, s, g, n).repeat_interleave(nh // g, 2)  # noqa: E731
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    chunk = min(cfg["ssm_chunk"], s)
    y = ops.ssd(x, dt, a, heads(b), heads(c), chunk) + x * p["D"][:, None]
    y = y.reshape(bs, s, d_in) * F.silu(z)
    y = ops.rms_norm(y, p["norm_scale"], GATED_NORM_EPS)
    return ops.linear(y, p["w_out"], precision)


def block(lp, x, cfg, precision):
    h = ops.rms_norm(x, lp["norm"]["scale"], cfg.get("norm_eps", 1e-5))
    return x + mixer(lp["mixer"], h, cfg, precision)


def hidden(params, tokens, cfg, precision):
    body = ops.checkpointed(lambda lp, x: block(lp, x, cfg, precision))
    x = params["embed"]["table"][tokens]
    for lp in params["layers"]:
        x = body(lp, x)
    return ops.rms_norm(x, params["final_norm"]["scale"],
                        cfg.get("norm_eps", 1e-5))


def head(params, h, precision):
    """Tied head: logits of hidden states h [..., D]."""
    return ops.linear(h, params["embed"]["table"].t(), precision)


def last_logits(params, tokens, cfg, precision="fp32"):
    """Logits [B, V] of the last position of each prompt."""
    return head(params, hidden(params, tokens, cfg, precision)[:, -1],
                precision)


def loss(params, tokens, targets, cfg, precision="fp32"):
    h = hidden(params, tokens, cfg, precision)
    return ops.cross_entropy(head(params, h, precision), targets)
