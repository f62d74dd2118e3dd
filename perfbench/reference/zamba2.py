"""The published Zamba2 (Zamba2-7B-Instruct's layer; ``transformers``'
``Zamba2Model``), plain fp32.

Every layer is a pre-norm residual Mamba2 block. With e the token
embedding and x the state (x = e at the first layer), a layer listed in
``hybrid_layer_ids`` is first preceded by a call of one of the
``num_mem_blocks`` shared blocks, taken in turn (call c: block c mod
num_mem_blocks):

    u = rmsnorm([x ; e])                          (2 d_model wide)
    q, k, v = u Wq, u Wk, u Wv;  RoPE (rotate-half, every dim) on q, k
    o = softmax(q kᵀ / sqrt(head_dim / 2) + causal) v Wo
    h = rmsnorm(o)                                (no residual in the block)
    [g ; p] = h W_gu + (h A_c) B_c                (call c's own adapter)
    tau = ((gelu(g) * p) W_down) L_c              (gelu: the exact erf form)
    x = x + mamba2(rmsnorm(x + tau))

and a plain layer is x = x + mamba2(rmsnorm(x)). A final RMSNorm and the
head tied to the embedding follow. The Mamba2 block is that of
``perfbench/reference/mamba2.py`` except its gated RMSNorm, which
normalises each of the ``ssm_ngroups`` groups of channels apart, at eps
1e-5, as the release's ``Zamba2RMSNormGated`` does. Every norm's eps is
``norm_eps`` (the release's ``rms_norm_eps``, 1e-5).

``cfg`` is the ``model`` group of a configuration's file; ``params`` the
benchmark's parameter tree in fp32, read by the port's leaf names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common as ops

GATED_NORM_EPS = 1e-5


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
    y = (y.reshape(bs, s, d_in) * F.silu(z)).reshape(bs, s, g, d_in // g)
    y = ops.rms_norm(y, 1.0, GATED_NORM_EPS).reshape(bs, s, d_in)
    return ops.linear(y * p["norm_scale"], p["w_out"], precision)


def rope(x, theta: float):
    """Rotate-half RoPE over every dim of x [B, S, H, hd], positions
    0..S-1."""
    hd, s = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(p, u, cfg, precision):
    """Causal multi-head attention of u [B, S, 2D], scale (hd / 2)^-1/2."""
    bs, s = u.shape[:2]
    h, hd = cfg["num_heads"], cfg["head_dim"]
    proj = lambda w: ops.linear(u, w.reshape(w.shape[0], -1),  # noqa: E731
                                precision).reshape(bs, s, -1, hd)
    q = rope(proj(p["wq"]), cfg.get("rope_theta", 10000.0))
    k = rope(proj(p["wk"]), cfg.get("rope_theta", 10000.0))
    v = proj(p["wv"])
    k = k.repeat_interleave(h // k.shape[2], 2)
    v = v.repeat_interleave(h // v.shape[2], 2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * (hd / 2) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)
    return ops.linear(o.reshape(bs, s, h * hd),
                      p["wo"].reshape(h * hd, -1), precision)


def shared_block(sp, adapter, linear, x, e, cfg, precision):
    """tau: one call of a shared block, through the layer's linear."""
    eps = cfg.get("norm_eps", 1e-5)
    u = ops.rms_norm(torch.cat([x, e], -1), sp["norm1"]["scale"], eps)
    h = ops.rms_norm(attention(sp["attn"], u, cfg, precision),
                     sp["norm2"]["scale"], eps)
    gu = ops.linear(h, sp["mlp"]["w_gate_up"], precision) + ops.linear(
        ops.linear(h, adapter["a"], precision), adapter["b"], precision)
    gate, up = gu.chunk(2, -1)
    out = ops.linear(F.gelu(gate) * up, sp["mlp"]["w_down"], precision)
    return ops.linear(out, linear["w"], precision)


def layer(lp, x, tau, cfg, precision):
    h = x if tau is None else x + tau
    h = ops.rms_norm(h, lp["norm"]["scale"], cfg.get("norm_eps", 1e-5))
    return x + mixer(lp["mixer"], h, cfg, precision)


def hidden(params, tokens, cfg, precision):
    plain = ops.checkpointed(
        lambda lp, x: layer(lp, x, None, cfg, precision))
    hybrid = ops.checkpointed(
        lambda lp, x, tau: layer(lp, x, tau, cfg, precision))
    shared = ops.checkpointed(
        lambda sp, ap, wp, x, e: shared_block(sp, ap, wp, x, e, cfg,
                                              precision))
    calls = [i for i in cfg["hybrid_layer_ids"] if i < len(params["layers"])]
    e = params["embed"]["table"][tokens]
    x = e
    for i, lp in enumerate(params["layers"]):
        if i in calls:
            c = calls.index(i)
            tau = shared(params["shared"][c % cfg["num_mem_blocks"]],
                         params["adapters"][c], params["linears"][c], x, e)
            x = hybrid(lp, x, tau)
        else:
            x = plain(lp, x)
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
