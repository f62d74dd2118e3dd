"""``tile_matmul``: the hop-consume form of the tile GEMM used by
``core/collective_matmul``.

It folds the middle dimensions into M, threads the optional carried
accumulator into the kernel (the travelling C tile of reduce-scatter
rings), and takes a batch of weights for the emulated ring: with
``w [P, K, N]`` every PE multiplies its own slice in one launch. The
kernel masks ragged M itself and its wrapper pads K and N, so unlike the
reference there is no fallback for shapes that do not tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.systolic_matmul import kernel


class _TileMatmul(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the plain product's gradient
    (the reference's ``_mm_fused`` custom VJP)."""

    @staticmethod
    def forward(ctx, a, b, c, out_dtype):
        ctx.save_for_backward(a, b)
        ctx.has_c = c is not None
        ctx.c_dtype = c.dtype if c is not None else None
        return kernel.matmul_cuda(a, b, c, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g32 = g.float()
        ga = torch.matmul(g32, b.float().transpose(1, 2)).to(a.dtype)
        gb = torch.matmul(a.float().transpose(1, 2), g32).to(b.dtype)
        gc = g.to(ctx.c_dtype) if ctx.has_c else None
        return ga, gb, gc, None


def tile_matmul(x, w, acc=None):
    """(acc +) x @ w with the middle dimensions folded into M.

    ``w [K, N]``: x is ``[..., K]`` and acc ``[..., N]`` (one PE, the
    reference's contract). ``w [P, K, N]``: x is ``[P, ..., K]`` and acc
    ``[P, ..., N]``, one product per PE in one launch. The output is fp32
    when acc is fp32, else the promoted input type (reference ops.py:117).
    """
    out_dtype = torch.promote_types(
        x.dtype, w.dtype if acc is None else acc.dtype)
    in_dtype = torch.promote_types(x.dtype, w.dtype)
    k, n = w.shape[-2], w.shape[-1]
    if w.dim() == 2:
        p, lead = 1, tuple(x.shape[:-1])
        w3 = w[None]
    else:
        p, lead = w.shape[0], tuple(x.shape[1:-1])
        if x.shape[0] != p:
            raise ValueError(f"tile_matmul: {tuple(x.shape)} has no PE dim "
                             f"of size {p}")
        w3 = w
    m = 1
    for dim in lead:
        m *= dim
    x3 = x.reshape(p, m, k).to(in_dtype)
    w3 = w3.to(in_dtype)
    c3 = acc.reshape(p, m, n) if acc is not None else None
    if x.device.type == "cpu":
        y = kernel.matmul_plain(x3, w3, c3, out_dtype)
    else:
        y = _TileMatmul.apply(x3, w3, c3, out_dtype)
    if w.dim() == 2:
        return y.reshape(*lead, n)
    return y.reshape(p, *lead, n)
