"""Weight-stationary 3x3 conv2d over the PEs' row blocks: the hand-written
CUDA kernel (``csrc/conv2d_3x3.cu``) and its plain PyTorch twin.

Both compute, for every PE p, the zero-padded 3x3 convolution of its rows
``x[p] [r, W]`` extended by one halo row above (``top[p]``) and one below
(``bot[p]``), each ``[P, 1, W]`` or None for zeros. Columns are zero-padded.
The accumulator is fp32 and sums the nine products in the reference
kernel's order (dr outer, dc inner); the output takes ``x``'s type.
``conv2d_3x3`` takes the twin for tensors on the CPU and launches the
kernel (or raises) otherwise.

The kernel has two bodies; :func:`conv_strip` picks one per call from the
shape, the type and the data pointers: the 16-byte body for rows that start
on 16-byte boundaries, the generic scalar body for every other width or
alignment. Either is one launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (
    Kernel,
    is_fake,
    require_cuda_tensors,
    stream_handle,
)
from repro_torch.obs import trace
from repro_torch.roofline import count

_P, _I = ctypes.c_void_p, ctypes.c_int
CONV2D_3X3 = Kernel("conv2d_3x3", {
    # x, top, bot, w, out, P, R, W, dtype, strip (0: generic body), stream
    "conv2d_3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
})
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

VEC_BYTES = 16        # one lane's columns in the 16-byte body
WHOLE_BLOCK = 64      # a PE block of up to this many rows is one strip
STRIP = 32            # rows per strip of a taller block


def conv_strip(shape, itemsize: int, addresses) -> int:
    """Rows per strip of the 16-byte body, or 0 for the generic body.

    ``shape`` is x's (P, R, W) and ``addresses`` the data pointers of x,
    out and the halos that are given. The 16-byte body needs every row to
    start on a 16-byte boundary: W a multiple of 16 / itemsize and every
    pointer 16-byte aligned. It reads each row once plus two halo rows per
    strip, so a PE block of at most ``WHOLE_BLOCK`` rows is one strip; a
    taller one is cut into strips of ``STRIP`` rows, which leaves enough
    warps (one per strip and 512-byte column band) to fill the card at the
    DSP paths' shapes."""
    _, r, w = shape
    if (w * itemsize) % VEC_BYTES or any(a % VEC_BYTES for a in addresses):
        return 0
    return r if r <= WHOLE_BLOCK else STRIP


def work(x, top, bot, weight):
    """(operations, bytes, type) of one launch: nine multiply-adds per
    output element; x, the halos and the taps read once, the output
    written once; fp32 arithmetic on the CUDA cores in both types."""
    return 18 * x.numel(), count.nbytes(x, top, bot, weight, x), "fp32"


def conv_plain(x, top, bot, weight):
    """The kernel's arithmetic in plain PyTorch."""
    p, r, w = x.shape
    zero = x.new_zeros(p, 1, w)
    ext = torch.cat([zero if top is None else top, x,
                     zero if bot is None else bot], dim=1).float()
    ext = F.pad(ext, (1, 1))
    k = weight.float()
    acc = torch.zeros(p, r, w, dtype=torch.float32, device=x.device)
    for dr in range(3):
        for dc in range(3):
            acc = acc + k[dr, dc] * ext[:, dr:dr + r, dc:dc + w]
    return acc.to(x.dtype)


def conv_cuda(x, top, bot, weight):
    """One launch of the CUDA kernel over all P row blocks."""
    require_cuda_tensors("conv2d_3x3", x, top, bot, weight)
    if x.dim() != 3 or tuple(weight.shape) != (3, 3):
        raise ValueError(f"conv2d_3x3: bad shapes x {tuple(x.shape)}, "
                         f"kernel {tuple(weight.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"conv2d_3x3: unsupported dtype {x.dtype}")
    p, r, w = x.shape
    for halo in (top, bot):
        if halo is not None and (tuple(halo.shape) != (p, 1, w)
                                 or halo.dtype != x.dtype):
            raise ValueError(f"conv2d_3x3: halo {tuple(halo.shape)} "
                             f"{halo.dtype} does not match {(p, 1, w)} "
                             f"{x.dtype}")
    x = x.contiguous()
    top = top.contiguous() if top is not None else None
    bot = bot.contiguous() if bot is not None else None
    w32 = weight.float().contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0 or is_fake(x, top, bot, weight):   # fake: dry run
        return out
    ptrs = [t.data_ptr() if t is not None else None
            for t in (x, top, bot, out)]
    strip = conv_strip((p, r, w), x.element_size(),
                       [a for a in ptrs if a is not None])
    err = CONV2D_3X3.lib().conv2d_3x3(
        *ptrs[:3], w32.data_ptr(), ptrs[3], p, r, w, DTYPE_CODES[x.dtype],
        strip, stream_handle(x.device))
    CONV2D_3X3.check(err)
    CONV2D_3X3.launches += 1
    return out


def conv2d_3x3(x, top, bot, kernel):
    """Plain twin for CPU tensors, the CUDA kernel otherwise, in the span
    ``kernel.conv2d_3x3``."""
    with count.kernel(CONV2D_3X3.name, lambda: work(x, top, bot, kernel)), \
            trace.span("kernel.conv2d_3x3"):
        if x.device.type == "cpu":
            return conv_plain(x, top, bot, kernel)
        return conv_cuda(x, top, bot, kernel)
