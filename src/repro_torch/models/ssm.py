"""Mamba2 layer via SSD (state-space duality, arXiv:2405.21060).

Mirrors ``repro/models/ssm.py``. The chunked SSD scan splits the selective
recurrence into intra-chunk attention-like products (the ``ssd_chunks``
kernel), per-chunk boundary states, and the inter-chunk linear recurrence,
a systolic chain (``kernels/ssd/ops.ssd``). Decode is the one-token
recurrence over a conv window and an SSM state per row.

Numerics follow the reference: the causal conv sums its K taps one by one
in the activation dtype, then adds the bias, then applies silu; the gated
RMSNorm normalises each of the ``cfg.ssm_ngroups`` groups of d_inner
apart (one group in every configuration the reference has, so the whole
d_inner there), with eps ``cfg.gated_norm_eps`` (1e-6 by default, not
``cfg.norm_eps``; the published Zamba2: 2 groups, 1e-5); ``A_log``, ``D``
and ``dt_bias`` are fp32 whatever the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.causal_conv.kernel import (  # noqa: F401
    causal_conv,
    causal_conv_plain as _causal_conv,   # the reference's _causal_conv
)
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.common import adtype, param, pdtype
from repro_torch.obs import trace


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, nheads, conv_dim


def init_mamba2(gen, cfg: ModelConfig):
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    d_in_proj = 2 * d_inner + 2 * g * n + nheads
    f32 = torch.float32
    return {
        "w_in": param(gen, (d, d_in_proj), pdtype(cfg)),
        "conv_w": param(gen, (cfg.ssm_conv_kernel, conv_dim), pdtype(cfg),
                        scale=0.5),
        "conv_b": param(gen, (conv_dim,), pdtype(cfg), "zeros"),
        "A_log": param(gen, (nheads,), f32, "zeros"),
        "D": param(gen, (nheads,), f32, "ones"),
        "dt_bias": param(gen, (nheads,), f32, "zeros"),
        "norm_scale": param(gen, (d_inner,), pdtype(cfg), "ones"),
        "w_out": param(gen, (d_inner, d), pdtype(cfg)),
    }


def _split_in_proj(zxbcdt, cfg: ModelConfig):
    d_inner, _, _ = ssm_dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * gn],
                       dim=-1)


def _split_xbc(xbc, cfg: ModelConfig):
    d_inner, _, _ = ssm_dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(xbc, [d_inner, gn, gn], dim=-1)


def _gated_norm_out(params, y, z, cfg: ModelConfig):
    """Gated RMSNorm (the gate inside the norm; each of
    ``cfg.ssm_ngroups`` groups of channels apart), then the out
    projection: the spans ``mamba2.gated_norm`` (up to the cast) and
    ``mamba2.out_proj``."""
    dt_ = adtype(cfg)
    groups = cfg.ssm_ngroups
    with trace.span("mamba2.gated_norm"):
        yf = y.float() * F.silu(z.float())
        if groups > 1:
            yf = yf.unflatten(-1, (groups, -1))
        var = yf.square().mean(dim=-1, keepdim=True)
        yf = yf * torch.rsqrt(var + cfg.gated_norm_eps)
        if groups > 1:
            yf = yf.flatten(-2)
        yf = (yf * params["norm_scale"].float()).to(dt_)
    with trace.span("mamba2.out_proj"):
        return torch.matmul(yf, params["w_out"].to(dt_))


def ssd_chunked(x, dt, A, B, C, D, cfg: ModelConfig, assoc_scan: bool = False,
                initial_state=None, return_final_state: bool = False):
    """Chunked SSD scan with chunk ``min(cfg.ssm_chunk, S)``; ``ssd``
    raises ValueError when S is not a multiple of it.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    B, C: [B,S,G,N]. Returns y [B,S,H,P] (+ final state [B,H,P,N])."""
    chunk = min(cfg.ssm_chunk, x.shape[1])
    return ssd(x, dt, A, B, C, D, chunk=chunk, assoc_scan=assoc_scan,
               initial_state=initial_state,
               return_final_state=return_final_state)


def mamba2_forward(params, x, cfg: ModelConfig):
    """Full-sequence Mamba2 layer. x: [B,S,D] -> [B,S,D]. The spans
    ``mamba2.in_proj``, ``mamba2.conv`` and ``mamba2.ssd`` mark the input
    product, the causal conv and the SSD scan."""
    dt_ = adtype(cfg)
    bsz, s, _ = x.shape
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    with trace.span("mamba2.in_proj"):
        zxbcdt = torch.matmul(x.to(dt_), params["w_in"].to(dt_))
    # x, B and C are adjacent columns of zxbcdt: the conv reads them in
    # place, as one strided view
    z, xbc, dtp = torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)
    with trace.span("mamba2.conv"):
        xbc = causal_conv(xbc, params["conv_w"].to(dt_),
                          params["conv_b"].to(dt_))
    xc, b, c = _split_xbc(xbc, cfg)
    xh = xc.reshape(bsz, s, nheads, cfg.ssm_headdim)
    dt = F.softplus(dtp.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"].float())
    with trace.span("mamba2.ssd"):
        y = ssd_chunked(xh, dt, A, b.reshape(bsz, s, g, n),
                        c.reshape(bsz, s, g, n), params["D"].float(), cfg)
    y = y.reshape(bsz, s, d_inner).to(dt_)
    return _gated_norm_out(params, y, z, cfg)


# ---------------------------------------------------------------------------
# Decode (single-step recurrence)
# ---------------------------------------------------------------------------


MAMBA2_CACHE_AXES = {
    "conv": ("cache_batch", None, "conv"),
    "state": ("cache_batch", "ssm_heads", None, None),
}


def init_mamba2_cache(cfg: ModelConfig, batch: int, device):
    _, nheads, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv_kernel - 1, conv_dim,
                            dtype=adtype(cfg), device=device),
        "state": torch.zeros(batch, nheads, cfg.ssm_headdim, cfg.ssm_state,
                             dtype=torch.float32, device=device),
    }


def mamba2_decode(params, x, cache, cfg: ModelConfig, active=None):
    """One-token step. x: [B,1,D] -> (y [B,1,D], new cache). Rows with
    active=False keep their conv and SSM state unchanged."""
    dt_ = adtype(cfg)
    bsz = x.shape[0]
    d_inner, nheads, _ = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    zxbcdt = torch.matmul(x.to(dt_), params["w_in"].to(dt_))
    z, xc, b, c, dtp = _split_in_proj(zxbcdt, cfg)
    window = torch.cat([cache["conv"], torch.cat([xc, b, c], dim=-1)],
                       dim=1)                                # [B,K,conv]
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"].to(dt_)) \
        + params["conv_b"].to(dt_)
    xbc = F.silu(conv_out)[:, None, :]
    new_conv = window[:, 1:]

    xc_, b_, c_ = _split_xbc(xbc, cfg)
    xh = xc_.reshape(bsz, nheads, cfg.ssm_headdim).float()
    dt = F.softplus(dtp[:, 0].float() + params["dt_bias"][None])
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A[None])                             # [B,H]
    rep = nheads // g
    bh = b_.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    ch = c_.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    state = cache["state"] * dA[..., None, None] \
        + (dt[..., None] * xh)[..., None] * bh[:, :, None, :]
    if active is not None:
        state = torch.where(active[:, None, None, None], state,
                            cache["state"])
        new_conv = torch.where(active[:, None, None], new_conv,
                               cache["conv"])
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = y + xh * params["D"][None, :, None]
    out = _gated_norm_out(params, y.reshape(bsz, 1, d_inner), z, cfg)
    return out, {"conv": new_conv, "state": state}
