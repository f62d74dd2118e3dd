"""Attention: GQA (RoPE, qk-norm, sliding window, bias), MLA (DeepSeek-V2)
and the Whisper decoder's cross-attention.

Mirrors ``repro/models/attention.py``. Where the reference
asks its mesh context whether a 'model' ring is present, the port takes
``n_pe``, the size of the emulated ring (0: no ring). When
``cfg.systolic_mode`` is a link mode and the shapes admit it, the QKV
projections run as one systolic ring (``core/collective_matmul``), prefill
attention as ring attention and decode attention as ring decode
(``core/ring_attention``). MLA and cross-attention have no ring path, as
in the reference. Under ``cfg.autotune`` a cached measured plan
(``repro_torch.autotune``) may rewrite the systolic fields first, and
turn the rings of a ``baseline`` config on.

MLA prefill expands the latent into per-head K/V (streaming KV blocks
through an online softmax at ``S >= BLOCKED_ATTN_THRESHOLD``); MLA decode
uses the absorbed formulation (the query projected into the latent space,
attention against the compressed cache), so a token's work scales with
the latent rank, not the expanded KV width.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import topology as topo_lib
from repro_torch.kernels.flash_attention.kernel import flash_carry_plain
from repro_torch.kernels.flash_attention.ops import zero_state
from repro_torch.models.common import (
    adtype,
    apply_rope,
    param,
    pdtype,
    rms_norm_simple,
)

_NEG_INF = -1e30
# Sequences at or above this length use the blocked (streaming) path.
BLOCKED_ATTN_THRESHOLD = 2048
KV_BLOCK = 512


def init_gqa(gen, cfg: ModelConfig, d_in: int | None = None):
    """The projections of ``d_in``-wide inputs (``d_model`` unless given;
    the published Zamba2 block reads state and embedding, 2 d_model) back
    to ``d_model``."""
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim
    dt = pdtype(cfg)
    p = {
        "wq": param(gen, (d, cfg.num_heads, hd), dt),
        "wk": param(gen, (d, cfg.num_kv_heads, hd), dt),
        "wv": param(gen, (d, cfg.num_kv_heads, hd), dt),
        "wo": param(gen, (cfg.num_heads, hd, cfg.d_model), dt),
    }
    if cfg.use_attn_bias:
        p["bq"] = param(gen, (cfg.num_heads, hd), dt, "zeros")
        p["bk"] = param(gen, (cfg.num_kv_heads, hd), dt, "zeros")
        p["bv"] = param(gen, (cfg.num_kv_heads, hd), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = param(gen, (hd,), dt, "ones")
        p["k_norm"] = param(gen, (hd,), dt, "ones")
    return p


def _expand_kv(k, num_heads: int):
    """[B,T,Kv,hd] -> [B,T,H,hd] by repeating KV heads (GQA)."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    return k.repeat_interleave(num_heads // kvh, dim=2)


def attn_scale(cfg: ModelConfig):
    """The configuration's softmax scale, 1/sqrt(head_dim *
    ``attn_scale_frac``) (the published Zamba2: 1/sqrt(head_dim / 2));
    None for 1/sqrt(head_dim), the kernels' and the plain paths'
    default."""
    if cfg.attn_scale_frac == 1.0:
        return None
    return (cfg.resolved_head_dim * cfg.attn_scale_frac) ** -0.5


def ring_size(cfg: ModelConfig, n_pe: int) -> int:
    """The ring the systolic paths may use: 0 in baseline mode or without
    a ring (the reference's ``_systolic_attn_ctx``)."""
    return n_pe if cfg.systolic_mode != "baseline" else 0


def _tuned(cfg: ModelConfig, op: str, shape, n_pe: int) -> ModelConfig:
    """Config.autotune gate of ``gqa_forward``, ``gqa_decode`` and
    ``moe.apply_moe``: rewrite the systolic fields from a cached measured
    plan for (op, shape) on the ring of ``n_pe`` (``autotune.tuned_cfg``:
    cache-only, defaults stand on a miss or with the flag off). Without a
    ring (``n_pe == 0``, the reference's missing mesh context) the config
    stands."""
    if n_pe == 0:
        return cfg
    from repro_torch.autotune.api import tuned_cfg
    return tuned_cfg(cfg, op, shape, n_pe)


def _sched(cfg: ModelConfig, n_pe: int, *, cycle_only: bool = False):
    """cfg.systolic_topology -> schedule (None keeps the +1 ring)."""
    if cfg.systolic_topology in ("", "ring"):
        return None
    return topo_lib.resolve_safe(cfg.systolic_topology, "model", n_pe,
                                 cycle_only=cycle_only)


def _qkv(params, x, cfg: ModelConfig, positions, n_pe: int = 0):
    dt = adtype(cfg)
    x = x.to(dt)
    n = ring_size(cfg, n_pe)
    from repro_torch.core import collective_matmul as cm
    if n and x.dim() == 3 and cm.attn_applicable(
            x, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, n):
        # one systolic x-stream feeds the three projection sinks
        q, k, v = cm.systolic_qkv(
            x, params["wq"].to(dt), params["wk"].to(dt), params["wv"].to(dt),
            n, cfg.systolic_mode, topo=_sched(cfg, n),
            block=cfg.kernel_block)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.use_attn_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm_simple(q, params["q_norm"])
        k = rms_norm_simple(k, params["k_norm"])
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def plain_attention(q, k, v, *, causal: bool, window: int = 0, scale=None):
    """Materialized-scores attention over aligned positions.
    q: [B,Sq,H,hd], k/v: [B,Skv,Kv,hd]. Returns fp32 [B,Sq,H,hd]."""
    b, sq, h, hd = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    scores = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    dq = torch.arange(sq, device=q.device)[:, None]
    dk = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = dk <= dq if causal else torch.ones_like(dk <= dq)
    if window:
        mask = mask & (dq - dk < window)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthk->bshk", probs, v.float())


def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      kv_block: int = KV_BLOCK, scale=None):
    """Online-softmax attention streaming KV blocks (flash-style): the
    per-block merge of the ring schedule, in plain torch on every device
    (the dense path launches no kernel)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    pad = (-skv) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    zero = torch.zeros((b,), dtype=torch.int32, device=q.device)
    state = zero_state(b, h, sq, hd, q.device)
    for start in range(0, k.shape[1], kv_block):
        state = flash_carry_plain(
            q, k[:, start:start + kv_block], v[:, start:start + kv_block],
            *state, zero, zero + start, zero + skv, causal=causal,
            window=window, scale=scale)
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # [B,H,Sq,hd]
    return out.transpose(1, 2)


def gqa_forward(params, x, cfg: ModelConfig, positions=None,
                return_kv: bool = False, n_pe: int = 0):
    """Full-sequence causal attention (prefill). x: [B,S,D]."""
    b, s, _ = x.shape
    cfg = _tuned(cfg, "attention", x.shape, n_pe)
    dt = adtype(cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions, n_pe)
    n = ring_size(cfg, n_pe)
    scale = attn_scale(cfg)
    out = None
    from repro_torch.core import ring_attention as ra
    if n and ra.ring_attn_applicable(q, k, n):
        # q shards stay resident, K/V blocks ride the ring
        out = ra.systolic_ring_attention(
            q, k, v, n, cfg.systolic_mode, causal=True,
            window=cfg.sliding_window, topo=_sched(cfg, n), scale=scale)
        used_ring = True
    else:
        used_ring = False
        if s >= BLOCKED_ATTN_THRESHOLD:
            out = blocked_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window, scale=scale)
        else:
            out = plain_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window, scale=scale)
    out = out.to(dt)
    # after ring attention the output is already sequence-sharded and the
    # out-projection is local to each shard; otherwise a reduce-scatter
    # ring carries head-shard partials to their sequence owners
    if (not used_ring and n > 1 and cfg.num_heads % n == 0 and s % n == 0):
        from repro_torch.core import collective_matmul as cm
        y = cm.systolic_out_proj(out, params["wo"].to(dt), n,
                                 cfg.systolic_mode, topo=_sched(cfg, n),
                                 block=cfg.kernel_block)
    else:
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    if return_kv:
        return y, (k, v)
    return y


# ----------------------------- decode cache -------------------------------

# logical axes of each cache leaf (the reference's): a serving backend
# finds a slot's row by "cache_batch"
GQA_CACHE_AXES = {
    "k": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "pos": ("cache_batch",),
}


def init_gqa_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    """Zeroed cache; sliding window uses a ring buffer."""
    hd = cfg.resolved_head_dim
    s_cache = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len
    shape = (batch, s_cache, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=adtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=adtype(cfg), device=device),
        # per-row positions: rows decode at independent offsets
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def gqa_decode(params, x, cache, cfg: ModelConfig, active=None,
               n_pe: int = 0):
    """One-token decode. x: [B,1,D]; per-row positions; rows with
    active=False neither write the cache nor advance.

    The cache is updated in place (the reference returns a new one): the
    k/v rows are written at ``min(pos, s_cache - 1)`` (a full cache
    overwrites its last slot) and ``pos`` advances. Where the reference
    points an inactive row's write past the cache and drops it, the port
    masks the write: the row rewrites its slot's old value. Returns
    (y [B,1,D], cache)."""
    pos = cache["pos"]                                       # [B]
    b = x.shape[0]
    cfg = _tuned(cfg, "decode", x.shape, n_pe)
    q, k, v = _qkv(params, x, cfg, pos[:, None], n_pe)
    k_all, v_all = cache["k"], cache["v"]
    s_cache = k_all.shape[1]
    if cfg.sliding_window:
        write_idx = torch.remainder(pos, s_cache)
    else:
        write_idx = torch.clamp(pos, max=s_cache - 1)
    rows = torch.arange(b, device=x.device)
    write_idx = write_idx.long()
    k_new, v_new = k[:, 0].to(k_all.dtype), v[:, 0].to(v_all.dtype)
    if active is not None:
        # an inactive row rewrites what its slot already holds (no
        # data-dependent shapes, so no wait on the device)
        keep = ~active[:, None, None]
        k_new = torch.where(keep, k_all[rows, write_idx], k_new)
        v_new = torch.where(keep, v_all[rows, write_idx], v_new)
    k_all[rows, write_idx] = k_new
    v_all[rows, write_idx] = v_new

    out = None
    n = ring_size(cfg, n_pe)
    from repro_torch.core import ring_attention as ra
    if n and not cfg.sliding_window and ra.ring_decode_applicable(q, k_all, n):
        out = ra.systolic_ring_decode(
            q, k_all, v_all, pos, n, cfg.systolic_mode,
            topo=_sched(cfg, n, cycle_only=True))
    if out is None:
        slot = torch.arange(s_cache, device=x.device)
        pos_c = pos[:, None].long()                          # [B,1]
        if cfg.sliding_window:
            # ring buffer: entry age = pos - stored position
            wrap = torch.remainder(pos_c, s_cache)
            stored_pos = torch.where(slot[None] <= wrap,
                                     pos_c - (wrap - slot[None]),
                                     pos_c - (wrap + s_cache - slot[None]))
            valid = (stored_pos >= 0) & \
                (pos_c - stored_pos < cfg.sliding_window)
        else:
            valid = slot[None] <= pos_c                      # [B, S]
        h, hd = q.shape[2], q.shape[3]
        ke = _expand_kv(k_all, h)
        ve = _expand_kv(v_all, h)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bshk,bthk->bhst", q.float(),
                              ke.float()) * scale            # [B,H,1,S]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthk->bshk", probs, ve.float())
    out = out.to(adtype(cfg))
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(adtype(cfg)))
    if active is None:
        pos += 1
    else:
        pos += active.to(pos.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = cfg.num_heads
    dt = pdtype(cfg)
    return {
        "wq": param(gen, (d, h, dn + dr), dt),
        "w_dkv": param(gen, (d, r + dr), dt),
        "kv_norm": param(gen, (r,), dt, "ones"),
        "w_uk": param(gen, (r, h, dn), dt),
        "w_uv": param(gen, (r, h, dv), dt),
        "wo": param(gen, (h, dv, d), dt),
    }


def _mla_latent(params, x, cfg: ModelConfig, positions):
    """x -> (normalized latent c [B,S,r], roped shared key k_rope
    [B,S,dr]); RoPE sees k_rope through an inserted head axis."""
    dt = adtype(cfg)
    r = cfg.kv_lora_rank
    ckv = torch.einsum("bsd,dr->bsr", x.to(dt), params["w_dkv"].to(dt))
    c, k_rope = ckv[..., :r], ckv[..., r:]
    c = rms_norm_simple(c, params["kv_norm"])
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c, k_rope


def _mla_queries(params, x, cfg: ModelConfig, positions):
    """x -> (q_nope [B,S,H,dn], roped q_rope [B,S,H,dr])."""
    dt = adtype(cfg)
    dn = cfg.qk_nope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x.to(dt), params["wq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_forward(params, x, cfg: ModelConfig, positions=None):
    """Full-sequence causal MLA (train / prefill), expanded formulation.
    x: [B,S,D] -> [B,S,D]."""
    b, s, _ = x.shape
    dt = adtype(cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_queries(params, x, cfg, positions)
    c, k_rope = _mla_latent(params, x, cfg, positions)
    scale = _mla_scale(cfg)
    if s >= BLOCKED_ATTN_THRESHOLD:
        out = _mla_blocked(params, q_nope, q_rope, c, k_rope, cfg, scale)
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", c, params["w_uk"].to(dt))
        v = torch.einsum("bsr,rhk->bshk", c, params["w_uv"].to(dt))
        scores = (torch.einsum("bshk,bthk->bhst", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 k_rope.float())) * scale
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthk->bshk", probs, v.float())
    return torch.einsum("bshk,hkd->bsd", out.to(dt), params["wo"].to(dt))


def _mla_blocked(params, q_nope, q_rope, c, k_rope, cfg: ModelConfig, scale,
                 kv_block: int = KV_BLOCK):
    """Streaming MLA prefill: K/V expanded from the latent one block at a
    time and folded into a carried online softmax. S is padded to whole
    blocks; keys past S are masked. Returns fp32 [B,S,H,dv]."""
    dt = adtype(cfg)
    b, s, h, _ = q_nope.shape
    dev = q_nope.device
    nblk = -(-s // kv_block)
    pad = nblk * kv_block - s
    c_p = torch.nn.functional.pad(c, (0, 0, 0, pad))
    kr_p = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    q_pos = torch.arange(s, device=dev)
    qn32, qr32 = q_nope.float(), q_rope.float()
    w_uk, w_uv = params["w_uk"].to(dt), params["w_uv"].to(dt)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, cfg.v_head_dim), dtype=torch.float32,
                      device=dev)
    for blk in range(nblk):
        cut = slice(blk * kv_block, (blk + 1) * kv_block)
        cblk = c_p[:, cut].to(dt)
        k_pos = blk * kv_block + torch.arange(kv_block, device=dev)
        k_nope = torch.einsum("btr,rhk->bthk", cblk, w_uk)
        vblk = torch.einsum("btr,rhk->bthk", cblk, w_uv)
        sc = (torch.einsum("bshk,bthk->bhst", qn32, k_nope.float())
              + torch.einsum("bshk,btk->bhst", qr32,
                             kr_p[:, cut].float())) * scale
        mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < s)
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthk->bhsk", p,
                                                   vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # [B,H,S,dv]
    return out.transpose(1, 2)


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    """Zeroed latent cache: the normalized latent and the roped shared
    key per position."""
    dt = adtype(cfg)
    return {
        "c": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dt,
                         device=device),
        "k_rope": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim),
                              dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


MLA_CACHE_AXES = {
    "c": ("cache_batch", "cache_seq", None),
    "k_rope": ("cache_batch", "cache_seq", None),
    "pos": ("cache_batch",),
}


def mla_decode(params, x, cache, cfg: ModelConfig, active=None):
    """Absorbed-matrix MLA decode: attention in the latent space, its
    latent products in fp32. x: [B,1,D]. The cache is updated in place as
    ``gqa_decode`` updates its own: the write goes to ``min(pos,
    s_cache - 1)``, an inactive row rewrites its slot's old value and
    keeps its position. Returns (y [B,1,D], cache)."""
    dt = adtype(cfg)
    pos = cache["pos"]                                       # [B]
    b = x.shape[0]
    c_all, kr_all = cache["c"], cache["k_rope"]
    s_cache = c_all.shape[1]
    positions = pos[:, None]
    q_nope, q_rope = _mla_queries(params, x, cfg, positions)  # [B,1,H,*]
    c_new, kr_new = _mla_latent(params, x, cfg, positions)    # [B,1,*]
    write_idx = torch.clamp(pos, max=s_cache - 1).long()
    rows = torch.arange(b, device=x.device)
    c_new, kr_new = c_new[:, 0].to(c_all.dtype), kr_new[:, 0].to(kr_all.dtype)
    if active is not None:
        keep = ~active[:, None]
        c_new = torch.where(keep, c_all[rows, write_idx], c_new)
        kr_new = torch.where(keep, kr_all[rows, write_idx], kr_new)
    c_all[rows, write_idx] = c_new
    kr_all[rows, write_idx] = kr_new

    # absorb: q_lat[b,h,r] = q_nope . W_uk
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                         params["w_uk"].float())
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_all.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_all.float())) * _mla_scale(cfg)
    valid = torch.arange(s_cache, device=x.device)[None] <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_all.float())
    out = torch.einsum("bshr,rhk->bshk", ctx_lat, params["w_uv"].float())
    y = torch.einsum("bshk,hkd->bsd", out.to(dt), params["wo"].to(dt))
    if active is None:
        pos += 1
    else:
        pos += active.to(pos.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (Whisper decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen, cfg: ModelConfig):
    """GQA's projections with a query bias only (no ``bk``/``bv``)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = pdtype(cfg)
    return {
        "wq": param(gen, (d, cfg.num_heads, hd), dt),
        "wk": param(gen, (d, cfg.num_kv_heads, hd), dt),
        "wv": param(gen, (d, cfg.num_kv_heads, hd), dt),
        "wo": param(gen, (cfg.num_heads, hd, d), dt),
        "bq": param(gen, (cfg.num_heads, hd), dt, "zeros"),
    }


def cross_kv(params, memory, cfg: ModelConfig):
    """Cross-attention K/V [B,T,Kv,hd] of the encoder output [B,T,D]."""
    dt = adtype(cfg)
    memory = memory.to(dt)
    k = torch.einsum("btd,dhk->bthk", memory, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", memory, params["wv"].to(dt))
    return k, v


def cross_attend(params, x, k, v, cfg: ModelConfig):
    """x: [B,S,D] queries against precomputed memory K/V (non-causal)."""
    dt = adtype(cfg)
    q = torch.einsum("bsd,dhk->bshk", x.to(dt), params["wq"].to(dt))
    q = q + params["bq"].to(dt)
    out = plain_attention(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out.to(dt), params["wo"].to(dt))
