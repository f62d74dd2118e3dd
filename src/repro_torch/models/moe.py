"""Mixture-of-Experts: token-choice top-k routing with capacity-based
scatter/gather dispatch (Mixtral 8x top-2, DeepSeek-V2 64x top-6 + shared).

Mirrors ``repro/models/moe.py``:
  * routing runs per batch row: softmax in fp32, top-k, the selected gates
    renormalised, and the Switch load-balancing auxiliary loss;
  * each assignment's rank within its expert (lower k-slot first, then the
    earlier token) decides capacity: ranks at or past ``cap`` drop;
  * the dense path gathers tokens into a ``[B, E, C, D]`` expert batch,
    runs the expert SwiGLU as batched products, and combines the outputs
    back by gate-weighted gather in fp32; shared experts add a plain
    SwiGLU. Its products are the reference's XLA einsums, so they stay
    ``torch`` products here.

When ``cfg.systolic_mode`` is a link mode and an emulated ring of ``n_pe``
PEs is given, ``apply_moe`` takes the expert-ring schedule of
``core/ring_moe`` instead (behind ``ring_moe_applicable``): expert shards
stay resident and routed token blocks ride the ring; its expert FFN runs
through the tile-matmul kernel. Under ``cfg.autotune`` a cached measured
plan for the ``moe`` op may rewrite the systolic fields (and the expert
FFN's tile) before that gate decides.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring_moe
from repro_torch.core import topology as topo_lib
from repro_torch.models.attention import _tuned, ring_size
from repro_torch.models.common import adtype, param, pdtype


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = int(seq_len * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    c = max(_round_up(max(c, 1), 16), 16)
    return min(c, _round_up(seq_len * cfg.experts_per_token, 16))


def init_moe(gen, cfg: ModelConfig):
    """Router (fp32 whatever the parameter dtype), the experts' SwiGLU
    weights stacked ``[E*sub, D, F/sub]`` (sub-experts split F), and the
    shared experts' SwiGLU when the config has any."""
    d = cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    e = cfg.num_experts
    sub = max(cfg.moe_subexperts, 1)
    if f % sub:
        raise ValueError(f"{sub} sub-experts do not divide d_ff {f}")
    es, fs_ = e * sub, f // sub
    dt = pdtype(cfg)
    p = {
        "router": param(gen, (d, e), torch.float32),
        "w_gate": param(gen, (es, d, fs_), dt),
        "w_up": param(gen, (es, d, fs_), dt),
        "w_down": param(gen, (es, fs_, d), dt),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": param(gen, (d, fs), dt),
            "w_up": param(gen, (d, fs), dt),
            "w_down": param(gen, (fs, d), dt),
        }
    return p


def _topk_routing(logits, cfg: ModelConfig):
    """logits [B,S,E] -> (weights [B,S,K], idx [B,S,K] int32, aux_loss).

    Exact ties go to the lower expert index, as ``jax.lax.top_k`` gives
    (a stable descending sort; ``torch.topk`` does not promise an order
    for ties)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, idx = weights[..., :k], idx[..., :k]
    # Mixtral/DeepSeek renormalize the selected gates
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    e = cfg.num_experts
    one_hot_top1 = F.one_hot(idx[..., 0], e).float()
    frac_tokens = one_hot_top1.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return weights, idx.to(torch.int32), aux


def _positions_in_expert(idx, e: int):
    """Rank of each assignment within its expert, per batch row.

    idx: [B,S,K] expert ids. Returns pos [B,S,K] int32: the 0-based arrival
    order, lower k-slot first (every primary choice outranks every
    secondary one), then the earlier token. Integer counts give the
    reference's values exactly (its fp32 cumsum is exact below 2**24)."""
    idx = idx.long()
    counts = torch.zeros(idx.shape[0], e, dtype=torch.long,
                         device=idx.device)
    pos = []
    for slot in range(idx.shape[-1]):
        oh = F.one_hot(idx[..., slot], e)                     # [B,S,E]
        within = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        pos.append(torch.gather(within, -1, idx[..., slot, None])[..., 0])
        counts = counts + oh.sum(dim=1)
    return torch.stack(pos, dim=-1).to(torch.int32)


def _dispatch_indices(idx, pos, e: int, cap: int):
    """Dense dispatch table: [B,E,C] token ids, the sentinel S for empty
    and overflowed slots (an overflowed assignment lands on a dropped
    slot C)."""
    b, s, k = idx.shape
    dev = idx.device
    slot = torch.where(pos < cap, pos, cap).long()
    tok = torch.arange(s, dtype=torch.int32, device=dev)[None, :, None] \
        .expand(b, s, k)
    b_idx = torch.arange(b, device=dev)[:, None, None].expand(b, s, k)
    dispatch = torch.full((b, e, cap + 1), s, dtype=torch.int32, device=dev)
    dispatch[b_idx, idx.long(), slot] = tok
    return dispatch[:, :, :cap]


def apply_moe(params, x, cfg: ModelConfig, n_pe: int = 0):
    """x: [B,S,D] -> (y [B,S,D], aux loss scaled by ``router_aux_loss``)."""
    dt = adtype(cfg)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = expert_capacity(cfg, s)

    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    weights, idx, aux = _topk_routing(logits, cfg)

    # a cached plan may flip the systolic fields before the ring gate
    cfg = _tuned(cfg, "moe", x.shape, n_pe)
    n = ring_size(cfg, n_pe)
    if n and ring_moe.ring_moe_applicable(cfg, x, n):
        # expert shards stay resident, token blocks and their routing ride
        # the ring (capacity ranks shared with the dense path below)
        pos = _positions_in_expert(idx, e)
        topo = None
        if cfg.systolic_topology not in ("", "ring"):
            topo = topo_lib.resolve_safe(cfg.systolic_topology, "model", n)
        y = ring_moe.systolic_ring_moe(
            x.to(dt), idx, pos, weights, params["w_gate"].to(dt),
            params["w_up"].to(dt), params["w_down"].to(dt), cap, n,
            cfg.systolic_mode, topo=topo, block=cfg.kernel_block)
        return y.to(dt), aux * cfg.router_aux_loss

    # sub-experts: a token routed to expert e goes to sub-experts
    # e*sub .. e*sub+sub-1 with the same gate; their down-proj partials sum
    sub = max(cfg.moe_subexperts, 1)
    if sub > 1:
        e, k = e * sub, k * sub
        idx = (idx[..., None] * sub + torch.arange(
            sub, dtype=idx.dtype, device=x.device)).reshape(b, s, k)
        weights = weights.repeat_interleave(sub, dim=-1)

    pos = _positions_in_expert(idx, e)                         # [B,S,K]
    keep = pos < cap
    dispatch = _dispatch_indices(idx, pos, e, cap).long()      # [B,E,C]

    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    x_e = torch.gather(x_pad[:, None].expand(b, e, s + 1, d), 2,
                       dispatch[..., None].expand(b, e, cap, d))  # [B,E,C,D]
    x_e = x_e.to(dt)
    gate = torch.einsum("becd,edf->becf", x_e, params["w_gate"].to(dt))
    up = torch.einsum("becd,edf->becf", x_e, params["w_up"].to(dt))
    h = F.silu(gate) * up
    out_e = torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))

    # combine: gate-weighted gather back to token order, in fp32
    flat = out_e.reshape(b, e * cap, d)
    gidx = (idx.long() * cap + torch.clamp(pos.long(), max=cap - 1)) \
        .reshape(b, s * k)
    out_tok = torch.gather(flat, 1, gidx[..., None].expand(b, s * k, d)) \
        .reshape(b, s, k, d)
    w = (weights * keep.to(weights.dtype))[..., None].float()
    y = torch.sum(out_tok.float() * w, dim=2).to(dt)

    if "shared" in params:
        sp = params["shared"]
        xd = x.to(dt)
        hs = F.silu(xd @ sp["w_gate"].to(dt)) * (xd @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)
    return y, aux * cfg.router_aux_loss
