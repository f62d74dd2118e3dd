"""Common model substrate: dtypes, parameter init from a
``torch.Generator``, the norms (RMS, LayerNorm, non-parametric LayerNorm),
rotary and sinusoidal positions, embedding, tied LM logits, the chunked
cross-entropy loss and the SwiGLU, GELU and gated-GELU MLPs. Mirrors
``repro/models/common.py``; parameters are plain nested dicts of tensors,
as the reference's value trees are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.obs import trace

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller asks otherwise; raises when CUDA is asked
    for and there is no GPU (never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def adtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def param(gen: torch.Generator, shape, dtype, init: str = "normal",
          scale: float | None = None) -> torch.Tensor:
    """A parameter on ``gen``'s device: fan-in-scaled normal by default."""
    dev = gen.device
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (v * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(gen, cfg: ModelConfig, d: int | None = None):
    """``rmsnorm``: a scale; ``layernorm``: a scale and a bias;
    ``nonparam_ln``: no parameters (an empty dict)."""
    d = d or cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": param(gen, (d,), pdtype(cfg), "ones")}
    if cfg.norm_type == "layernorm":
        return {"scale": param(gen, (d,), pdtype(cfg), "ones"),
                "bias": param(gen, (d,), pdtype(cfg), "zeros")}
    if cfg.norm_type == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(params, x, cfg: ModelConfig, eps: float | None = None):
    """The norm of ``cfg.norm_type`` in fp32; the LayerNorms take the
    population variance, as ``jnp.var`` does."""
    eps = eps or cfg.norm_eps
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm_type == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm_simple(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)         # [hd/2]
    angles = positions[..., :, None].float() * freqs            # [..., s, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                    # [..., s, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num_pos: int, d: int,
                         device="cuda") -> torch.Tensor:
    """Whisper-style sinusoidal position table [num_pos, d], fp32, on
    ``device`` (the caller's; ``cuda`` unless it asks otherwise)."""
    device = resolve_device(device)
    log_ts_incr = math.log(10000.0) / max(d // 2 - 1, 1)
    inv = torch.exp(-log_ts_incr * torch.arange(d // 2, dtype=torch.float32,
                                                device=device))
    scaled = torch.arange(num_pos, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# Embeddings & LM head
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ModelConfig):
    return {"table": param(gen, (cfg.vocab_size, cfg.d_model), pdtype(cfg),
                           scale=0.02)}


def embed(params, tokens, cfg: ModelConfig):
    return F.embedding(tokens.long(), params["table"]).to(adtype(cfg))


def _logits(head_params, embed_params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.matmul(x.float(), embed_params["table"].float().t())
    return torch.matmul(x.float(), head_params["w"].float())


def lm_logits(head_params, embed_params, x, cfg: ModelConfig):
    """Final projection to vocab (tied or untied), the span
    ``model.head``. Returns fp32 logits."""
    with trace.span("model.head"):
        return _logits(head_params, embed_params, x, cfg)


def init_lm_head(gen, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": param(gen, (cfg.d_model, cfg.vocab_size), pdtype(cfg))}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _ce(logits, targets, z_loss: float):
    """Per-position CE of fp32 logits [..., V] (and its z-loss term)."""
    lse = torch.logsumexp(logits, dim=-1)
    ce = lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    return ce


def lm_loss_chunked(head_params, embed_params, x, targets, cfg: ModelConfig,
                    mask=None, chunk: int = 512, z_loss: float = 0.0):
    """CE loss without materializing [B,S,V] logits.

    Loops over sequence chunks; each chunk's logits are computed, reduced
    to (sum of masked ce, sum of mask) and recomputed in the backward pass
    (``torch.utils.checkpoint``), so peak memory is O(B * chunk * V)
    instead of O(B * S * V). A ragged tail is padded with masked-out
    positions, as in the reference. The forward is the span
    ``model.head``.
    """
    with trace.span("model.head"):
        return _loss_chunked(head_params, embed_params, x, targets, cfg,
                             mask, chunk, z_loss)


def _loss_chunked(head_params, embed_params, x, targets, cfg, mask, chunk,
                  z_loss):
    b, s, _ = x.shape
    if s <= chunk:
        logits = _logits(head_params, embed_params, x, cfg)
        return softmax_cross_entropy(logits, targets, mask, z_loss)
    nch = -(-s // chunk)
    pad = nch * chunk - s
    mask_full = (mask.float() if mask is not None
                 else torch.ones((b, s), dtype=torch.float32,
                                 device=x.device))
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask_full = F.pad(mask_full, (0, pad))

    def chunk_loss(xs, ts, ms):
        logits = _logits(head_params, embed_params, xs, cfg)
        ce = _ce(logits, ts, z_loss)
        return torch.sum(ce * ms), torch.sum(ms)

    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nch):
        cut = slice(i * chunk, (i + 1) * chunk)
        n_c, d_c = checkpoint(chunk_loss, x[:, cut], targets[:, cut],
                              mask_full[:, cut], use_reentrant=False)
        num, den = num + n_c, den + d_c
    return num / torch.clamp(den, min=1.0)


def softmax_cross_entropy(logits, targets, mask=None, z_loss: float = 0.0):
    """Mean CE over (optionally masked) positions. logits [..., V]."""
    ce = _ce(logits.float(), targets, z_loss)
    if mask is not None:
        mask = mask.float()
        return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff: int | None = None):
    """``swiglu``: gate, up and down; ``geglu``: gate and up as one
    product (gate the first half) and down, no biases; any other kind is
    the GELU MLP (up and down with zero biases), as in the reference."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind == "geglu":
        return {"w_gate_up": param(gen, (d, 2 * f), pdtype(cfg)),
                "w_down": param(gen, (f, d), pdtype(cfg))}
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": param(gen, (d, f), pdtype(cfg)),
            "w_up": param(gen, (d, f), pdtype(cfg)),
            "w_down": param(gen, (f, d), pdtype(cfg)),
        }
    return {
        "w_up": param(gen, (d, f), pdtype(cfg)),
        "b_up": param(gen, (f,), pdtype(cfg), "zeros"),
        "w_down": param(gen, (f, d), pdtype(cfg)),
        "b_down": param(gen, (d,), pdtype(cfg), "zeros"),
    }


def apply_mlp(params, x, cfg: ModelConfig, adapter=None):
    """SwiGLU; the gated GELU (exact erf GELU of the gate times the up
    half; ``adapter`` {a [D, r], b [r, 2F]} adds ``(x a) b`` to the gate/up
    product, a call's own low-rank term); or the GELU MLP with
    ``jax.nn.gelu``'s default, the tanh approximation."""
    dt = adtype(cfg)
    x = x.to(dt)
    if cfg.mlp_kind == "geglu":
        gu = torch.matmul(x, params["w_gate_up"].to(dt))
        if adapter is not None:
            low = torch.matmul(x, adapter["a"].to(dt))
            gu = gu + torch.matmul(low, adapter["b"].to(dt))
        gate, up = gu.chunk(2, dim=-1)
        return torch.matmul(F.gelu(gate) * up, params["w_down"].to(dt))
    if cfg.mlp_kind == "swiglu":
        gate = torch.matmul(x, params["w_gate"].to(dt))
        up = torch.matmul(x, params["w_up"].to(dt))
        return torch.matmul(F.silu(gate) * up, params["w_down"].to(dt))
    h = torch.matmul(x, params["w_up"].to(dt))
    h = F.gelu(h + params["b_up"].to(dt), approximate="tanh")
    return torch.matmul(h, params["w_down"].to(dt)) + params["b_down"].to(dt)
