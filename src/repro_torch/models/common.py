"""Common model substrate of the dense slice: dtypes, parameter init from a
``torch.Generator``, RMS norms, rotary embeddings, embedding, tied LM
logits, the chunked cross-entropy loss and the SwiGLU MLP. Mirrors
``repro/models/common.py``; parameters are plain nested dicts of tensors,
as the reference's value trees are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

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
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm_type!r} is not ported")
    return {"scale": param(gen, (d or cfg.d_model,), pdtype(cfg), "ones")}


def apply_norm(params, x, cfg: ModelConfig, eps: float | None = None):
    eps = eps or cfg.norm_eps
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Embeddings & LM head
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ModelConfig):
    return {"table": param(gen, (cfg.vocab_size, cfg.d_model), pdtype(cfg),
                           scale=0.02)}


def embed(params, tokens, cfg: ModelConfig):
    return F.embedding(tokens.long(), params["table"]).to(adtype(cfg))


def lm_logits(head_params, embed_params, x, cfg: ModelConfig):
    """Final projection to vocab (tied or untied). Returns fp32 logits."""
    if cfg.tie_embeddings:
        return torch.matmul(x.float(), embed_params["table"].float().t())
    return torch.matmul(x.float(), head_params["w"].float())


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
    positions, as in the reference.
    """
    b, s, _ = x.shape
    if s <= chunk:
        logits = lm_logits(head_params, embed_params, x, cfg)
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
        logits = lm_logits(head_params, embed_params, xs, cfg)
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
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r} is not ported")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": param(gen, (d, f), pdtype(cfg)),
        "w_up": param(gen, (d, f), pdtype(cfg)),
        "w_down": param(gen, (f, d), pdtype(cfg)),
    }


def apply_mlp(params, x, cfg: ModelConfig):
    dt = adtype(cfg)
    x = x.to(dt)
    gate = torch.matmul(x, params["w_gate"].to(dt))
    up = torch.matmul(x, params["w_up"].to(dt))
    return torch.matmul(F.silu(gate) * up, params["w_down"].to(dt))
