"""Mamba2 SSD intra-chunk pass: the hand-written CUDA kernel
(``csrc/ssd_chunks.cu``) and its plain PyTorch twin.

Both take the reference kernel's contract (``repro/kernels/ssd/kernel.py``):

    x  [BH, NC, L, P]  (fp32 or bf16; batch*heads, chunks, chunk, headdim)
    dt [BH, NC, L, 1]  fp32, post-softplus
    a  [BH, 1, 1, 1]   fp32, the negative per-head decay rate
    b, c [BG, NC, L, N] (x's type; batch*groups), shared by the heads of a
       group: head i reads row ``(i // nheads) * G + (i % nheads) // (nheads
       // G)``, the reference's ``bc_index``

and return ``y_intra [BH,NC,L,P]``, ``states [BH,NC,P,N]`` and ``expcum
[BH,NC,L,1]``, all fp32. ``cum = cumsum(dt * a)`` is the fp32 rounding of
prefix sums taken in float64, so kernel and twin get the same ``cum``
whatever order each sums in (``cum`` is differenced and exponentiated,
which would amplify an order's rounding). The causal decay is a select,
never a product with a mask: above the diagonal ``exp(cum[t] - cum[s])``
overflows at realistic ``dt``. ``ssd_chunks`` takes the twin for tensors
on the CPU and launches the kernel (or raises) otherwise, through
``_SSDChunks``: the kernel's forward, and for its backward the gradient of
the twin (the reference has no backward kernel: its VJP is jnp autodiff).

The kernel has two bodies behind one launch: bf16 inputs run on the tensor
cores (``mma.sync``, with M = (C B^T) * decay * dt and x * w each split into
two bf16 halves, so that the fp32 twin's 1e-4 bound holds), fp32 inputs on
the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from repro_torch.kernels._build import (
    Kernel,
    is_fake,
    require_cuda_tensors,
    stream_handle,
)
from repro_torch.roofline import count

_P, _I = ctypes.c_void_p, ctypes.c_int
SSD_CHUNKS = Kernel("ssd_chunks", {
    # x, dt, a, b, c, y, states, expcum, BH, NC, L, P, N, nheads, ngroups,
    # dtype, stream
    "ssd_chunks": [_P] * 8 + [_I] * 8 + [_P],
})
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128          # the kernel's register micro tiles


def group_rows(bh: int, nheads: int, ngroups: int, device) -> torch.Tensor:
    """Row of the [BG, ...] B/C arrays that each of the BH heads reads."""
    i = torch.arange(bh, device=device)
    return (i // nheads) * ngroups + (i % nheads) // (nheads // ngroups)


def _check(x, dt, a, b, c, nheads: int, ngroups: int):
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd_chunks: bad ranks x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    bh, nc, l, p = x.shape
    if nheads <= 0 or ngroups <= 0 or nheads % ngroups or bh % nheads:
        raise ValueError(f"ssd_chunks: {bh} rows, nheads={nheads}, "
                         f"ngroups={ngroups} do not divide")
    bg = bh // nheads * ngroups
    if tuple(b.shape[:3]) != (bg, nc, l) or tuple(dt.shape) != (bh, nc, l, 1) \
            or tuple(a.shape) != (bh, 1, 1, 1):
        raise ValueError(f"ssd_chunks: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not match")


def ssd_flops(bh: int, bg: int, nc: int, l: int, p: int, n: int):
    """(the operations the function needs, the operations the reference's
    kernel does) over BH head rows and BG group rows. Needed: the causal
    triangle of C Bᵀ once per (group row, chunk), the causal triangle of
    M x and the boundary state per (head row, chunk). The reference's
    kernel: 2 L² N for C Bᵀ, 2 L² P for M x and 2 L P N for the state, per
    (head row, chunk)."""
    tri = l * (l + 1) // 2
    return (bg * nc * 2 * tri * n + bh * nc * (2 * tri * p + 2 * l * p * n),
            bh * nc * (2 * l * l * n + 2 * l * l * p + 2 * l * p * n))


def work(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """(operations, bytes, type) of one launch: the operations the
    function needs (``ssd_flops``); the five inputs read once and the
    three fp32 outputs written once; on the tensor cores for bf16."""
    bh, nc, l, p = x.shape
    bg, n = b.shape[0], b.shape[-1]
    moved = count.nbytes(x, dt, a, b, c) + 4 * bh * nc * (l * p + p * n + l)
    kind = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    return ssd_flops(bh, bg, nc, l, p, n)[0], moved, kind


def ssd_chunks_plain(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """The reference kernel's body batched over (BH, NC), in fp32."""
    _check(x, dt, a, b, c, nheads, ngroups)
    bh, nc, l, _ = x.shape
    rows = group_rows(bh, nheads, ngroups, x.device)
    xf = x.float()
    dtf = dt.float()[..., 0]                                  # [BH,NC,L]
    bf, cf = b.float(), c.float()
    da = dtf * a.float().reshape(bh, 1, 1)
    cum = torch.cumsum(da.double(), dim=-1).float()
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    # exp of -inf above the diagonal: the same zeros as a select after the
    # exp, and a zero gradient there (0 * exp(overflow) would be NaN)
    decay = torch.exp(torch.where(mask, diff, float("-inf")))
    cb = torch.matmul(cf, bf.transpose(-1, -2))[rows]         # [BH,NC,L,L]
    m = cb * decay * dtf[..., None, :]
    y = torch.matmul(m, xf)
    w = torch.exp(cum[..., -1:] - cum) * dtf
    states = torch.matmul((xf * w[..., None]).transpose(-1, -2), bf[rows])
    return y, states, torch.exp(cum)[..., None]


def ssd_chunks_cuda(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """One launch of the CUDA kernel over every (head, chunk)."""
    require_cuda_tensors("ssd_chunks", x, dt, a, b, c)
    _check(x, dt, a, b, c, nheads, ngroups)
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"ssd_chunks: x/b/c must share fp32 or bf16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_chunks: dt and a must be fp32, got "
                        f"{dt.dtype}, {a.dtype}")
    bh, nc, l, p = x.shape
    n = b.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_chunks: headdim {p} > {MAX_P} or state {n} > "
                         f"{MAX_N} is not taken by the kernel")
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(bh, nc, l, p, **f32)
    states = torch.empty(bh, nc, p, n, **f32)
    expcum = torch.empty(bh, nc, l, 1, **f32)
    if x.numel() == 0 or is_fake(x, dt, a, b, c):   # fake: a dry run's
        return y, states, expcum
    err = SSD_CHUNKS.lib().ssd_chunks(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), states.data_ptr(), expcum.data_ptr(),
        bh, nc, l, p, n, nheads, ngroups, DTYPE_CODES[x.dtype],
        stream_handle(x.device))
    SSD_CHUNKS.check(err)
    SSD_CHUNKS.launches += 1
    return y, states, expcum


class _SSDChunks(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd of the plain twin,
    under the profiler label ``ssd_chunks_backward``."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, nheads, ngroups):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.opts = dict(nheads=nheads, ngroups=ngroups)
        return ssd_chunks_cuda(x, dt, a, b, c, **ctx.opts)

    @staticmethod
    def backward(ctx, *grads):
        diff = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad(), record_function("ssd_chunks_backward"):
            outs = ssd_chunks_plain(*diff, **ctx.opts)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], diff,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        return (*got, None, None)


def ssd_chunks(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """Plain twin for CPU tensors, the CUDA kernel otherwise."""
    with count.kernel(SSD_CHUNKS.name, lambda: work(
            x, dt, a, b, c, nheads=nheads, ngroups=ngroups)):
        if x.device.type == "cpu":
            return ssd_chunks_plain(x, dt, a, b, c, nheads=nheads,
                                    ngroups=ngroups)
        return _SSDChunks.apply(x, dt, a, b, c, nheads, ngroups)
