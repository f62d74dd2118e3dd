"""``tile_matmul``: the hop-consume form of the tile GEMM used by
``core/collective_matmul``.

It folds the middle dimensions into M, threads the optional carried
accumulator into the kernel (the travelling C tile of reduce-scatter
rings), and takes a batch of weights for the emulated ring: with
``w [P, K, N]`` every PE multiplies its own slice in one launch. The
kernel masks ragged M itself and its wrapper pads K and N, so unlike the
reference there is no fallback for shapes that do not tile.

``block`` is the autotuner's tile knob (``ModelConfig.kernel_block``): 0
keeps the kernel's own choice; 64 or 128 force the bf16 body's output
tile to 128 x block, or the fp32 body's to block x block (the reference
sets ``bm = bn = bk = block``; the port's bf16 body keeps its 128 rows
and 64-deep K tiles). The plain version on the CPU ignores it, as the
reference's jnp path does; any other value raises on every device.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels.systolic_matmul import kernel
from repro_torch.roofline import count


class _TileMatmul(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the gradient of the reference's
    plain form ``(c +) a.astype(out) @ b.astype(out)`` (``_mm_fused``'s
    custom VJP): both products in the output type (bf16 hops: bf16
    operands, fp32 accumulation), each gradient in its input's type. The
    backward runs under the profiler label ``tile_matmul_backward``."""

    @staticmethod
    def forward(ctx, a, b, c, out_dtype, block=0):
        ctx.save_for_backward(a, b)
        ctx.has_c = c is not None
        ctx.c_dtype = c.dtype if c is not None else None
        ctx.out_dtype = out_dtype
        return kernel.matmul_cuda(a, b, c, out_dtype, block)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dt = ctx.out_dtype
        with record_function("tile_matmul_backward"):
            g = g.to(dt)
            ga = torch.matmul(g, b.to(dt).transpose(1, 2)).to(a.dtype)
            gb = torch.matmul(a.to(dt).transpose(1, 2), g).to(b.dtype)
            gc = g.to(ctx.c_dtype) if ctx.has_c else None
        return ga, gb, gc, None, None


def tile_matmul(x, w, acc=None, block: int = 0):
    """(acc +) x @ w with the middle dimensions folded into M.

    ``w [K, N]``: x is ``[..., K]`` and acc ``[..., N]`` (one PE, the
    reference's contract). ``w [P, K, N]``: x is ``[P, ..., K]`` and acc
    ``[P, ..., N]``, one product per PE in one launch. The output is fp32
    when acc is fp32, else the promoted input type (reference ops.py:117).
    ``block`` is the output tile (``kernel.BLOCKS``; 0: the kernel's own).
    """
    block = kernel.check_block(block)
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
    with count.kernel(kernel.TILE_MATMUL.name,
                      lambda: kernel.work(x3, w3, c3, out_dtype)):
        if x.device.type == "cpu":
            y = kernel.matmul_plain(x3, w3, c3, out_dtype)
        else:
            y = _TileMatmul.apply(x3, w3, c3, out_dtype, block)
    if w.dim() == 2:
        return y.reshape(*lead, n)
    return y.reshape(p, *lead, n)
