"""Building blocks of the reference, in fp32.

``precision`` is ``"fp32"`` (the reference) or ``"fp8"`` (the control: the
same computation with both operands of every weight product rounded to
float8 e4m3 at a per-tensor scale, the step below the configurations'
bf16; its gradient passes straight through the rounding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
E4M3_MAX = 448.0


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _E4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-12)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


def linear(x, w, precision: str):
    """x [..., K] @ w [K, N]."""
    if precision == "fp8":
        x, w = _E4M3.apply(x), _E4M3.apply(w)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return x @ w


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def causal_conv(x, w, b):
    """Depthwise causal conv1d: x [B,S,C], w [K,C] (w[K-1] on the current
    position), b [C]."""
    k, s = w.shape[0], x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), b, padding=k - 1,
                 groups=x.shape[-1])
    return y[..., :s].transpose(1, 2)


def segsum(x):
    """[..., T] -> [..., T, T]: out[i, j] = x[j+1] + ... + x[i] for i >= j,
    -inf above the diagonal (the stable segment sum of the Mamba2 paper's
    minimal SSD)."""
    t = x.shape[-1]
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device),
                       -1)
    xx = x[..., None].expand(*x.shape, t).masked_fill(~below, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk: int):
    """The SSD scan by chunks (arXiv:2405.21060, the minimal listing):
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_tᵀ, y_t = h_t c_t.
    x [B,S,H,P], dt [B,S,H], a [H], b, c [B,S,H,N] -> y [B,S,H,P]."""
    bs, s, h, p = x.shape
    n, nc, l = b.shape[-1], s // chunk, chunk
    xs = (x * dt[..., None]).reshape(bs, nc, l, h, p)
    adt = (dt * a).reshape(bs, nc, l, h).permute(0, 3, 1, 2)     # [B,H,C,L]
    bc = b.reshape(bs, nc, l, h, n)
    cc = c.reshape(bs, nc, l, h, n)
    cum = torch.cumsum(adt, -1)
    decay = torch.exp(segsum(adt)).permute(0, 2, 1, 3, 4)         # [B,C,H,L,L]
    m = torch.einsum("bclhn,bcshn->bchls", cc, bc) * decay
    y_diag = torch.einsum("bchls,bcshp->bclhp", m, xs)
    tail = torch.exp(cum[..., -1:] - cum)                         # [B,H,C,L]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bc, tail, xs)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    chain = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))        # [B,H,C+1,C+1]
    entering = torch.einsum("bhzc,bchpn->bzhpn", chain, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cc, entering,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(bs, s, h, p)


def cross_entropy(logits, targets):
    """Mean over every position of logsumexp - the target's logit."""
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


def checkpointed(fn):
    """``fn`` recomputed in the backward while gradients are recorded, so
    that a whole model's fp32 activations need not be held at once."""
    from torch.utils.checkpoint import checkpoint
    if not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)
