"""Batched output-stationary tile GEMM: the hand-written CUDA kernel
(``csrc/tile_matmul.cu``) and its plain PyTorch twin.

Both compute ``O[p] = (C[p] +) A[p] @ B[p]`` for ``A [P,M,K]``,
``B [P,K,N]``, ``C [P,M,N]`` with an fp32 accumulator seeded from C and one
rounding to ``out_dtype`` at the end. ``ops.tile_matmul`` takes the twin
for tensors on the CPU and launches the kernel (or raises) otherwise.
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
from repro_torch.roofline.count import nbytes

_P, _I = ctypes.c_void_p, ctypes.c_int
TILE_MATMUL = Kernel("tile_matmul", {
    # a, b, c, out, P, M, N, K, in_dtype, c_dtype, out_dtype, block, stream
    "tile_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
})
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K and N must be multiples of these for the kernel's body of each input type
K_QUANTUM = {torch.float32: 1, torch.bfloat16: 8}
N_QUANTUM = {torch.float32: 4, torch.bfloat16: 8}
# the block knob: 0 keeps the launcher's own tile; 64 and 128 force BN of
# the bf16 body's 128 x BN tile, or the fp32 body's square tile
BLOCKS = (0, 64, 128)


def check_block(block) -> int:
    """``block`` as an int, or ``ValueError`` unless it is in ``BLOCKS``."""
    if block not in BLOCKS:
        raise ValueError(f"tile_matmul: block {block!r} is not one of "
                         f"{BLOCKS}")
    return int(block)


def _pad_to(x: int, q: int) -> int:
    return -(-x // q) * q


def _aligned16(t):
    """``t`` itself, or a copy when its data does not start on 16 bytes."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def work(a, b, c=None, out_dtype=None) -> tuple[int, int, str]:
    """(operations, bytes, type) of one launch: 2·P·M·K·N multiply-adds
    counted as two operations each; A, B and C read once and the output
    written once; on the tensor cores for bf16 inputs."""
    p, m, k = a.shape
    n = b.shape[-1]
    moved = nbytes(a, b, c) + p * m * n * (out_dtype or a.dtype).itemsize
    return 2 * p * m * k * n, moved, ("bf16" if a.dtype == torch.bfloat16
                                      else "fp32")


def matmul_plain(a, b, c=None, out_dtype=None):
    """The kernel's arithmetic in plain PyTorch: fp32 accumulation seeded
    from ``c``, rounded once to ``out_dtype`` (default ``a.dtype``)."""
    out_dtype = out_dtype or a.dtype
    y = torch.matmul(a.float(), b.float())
    if c is not None:
        y = c.float() + y
    return y.to(out_dtype)


def matmul_cuda(a, b, c=None, out_dtype=None, block: int = 0):
    """One launch of the CUDA tile GEMM over all P batches; ``block``
    (``BLOCKS``) picks the output tile, 0 leaves it to the launcher."""
    out_dtype = out_dtype or a.dtype
    block = check_block(block)
    require_cuda_tensors("tile_matmul", a, b, c)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"tile_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES \
            or out_dtype not in DTYPE_CODES:
        raise TypeError(f"tile_matmul: unsupported dtypes {a.dtype}, "
                        f"{b.dtype} -> {out_dtype}")
    p, m, k = a.shape
    n = b.shape[2]
    if c is not None:
        if tuple(c.shape) != (p, m, n) or c.dtype not in DTYPE_CODES:
            raise ValueError(f"tile_matmul: carry-in {tuple(c.shape)} "
                             f"{c.dtype} does not match {(p, m, n)}")
        c = c.contiguous()
    a, b = a.contiguous(), b.contiguous()
    if p * m * n == 0 or is_fake(a, b, c):      # fake: a dry run's shapes
        return torch.empty((p, m, n), dtype=out_dtype, device=a.device)
    # the wgmma body reads K and N in 16-byte chunks of bf16, the SGEMM body
    # N in 16-byte chunks of fp32: pad what does not fill whole chunks
    k_pad = _pad_to(k, K_QUANTUM[a.dtype])
    n_pad = _pad_to(n, N_QUANTUM[a.dtype])
    if k_pad != k:
        a = F.pad(a, (0, k_pad - k))
        b = F.pad(b, (0, 0, 0, k_pad - k))
    if n_pad != n:
        b = F.pad(b, (0, n_pad - n))
        c = F.pad(c, (0, n_pad - n)) if c is not None else None
    a, b, c = (_aligned16(x) for x in (a, b, c))
    out = torch.empty((p, m, n_pad), dtype=out_dtype, device=a.device)
    err = TILE_MATMUL.lib().tile_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr() if c is not None else None,
        out.data_ptr(),
        p, m, n_pad, k_pad, DTYPE_CODES[a.dtype],
        DTYPE_CODES[c.dtype] if c is not None else -1,
        DTYPE_CODES[out_dtype], block, stream_handle(a.device))
    TILE_MATMUL.check(err)
    TILE_MATMUL.launches += 1
    return out if n_pad == n else out[..., :n].contiguous()
