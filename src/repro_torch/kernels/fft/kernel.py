"""Radix-4 DIT FFT stage over row blocks, each at a stage of its own: the
hand-written CUDA kernel (``csrc/fft_stage.cu``) and its plain PyTorch
twin.

Both take ``x [P, B, n]`` complex64, ``stage [P]`` int32 with values in
``[0, D)`` (D = log4 n), and the twiddle table ``tw [D, n]`` complex64 whose
row s holds stage s's twiddles (``core/fft.twiddle_table``). Row block p
gets stage ``stage[p]``: the twiddle multiply, then the radix-4 butterflies
over groups of ``4^(s+1)``, in fp32. With ``reverse`` the rows at stage 0
first load their points in digit-reversed order (the cfft's shared-memory
load). A stage outside ``[0, D)`` yields NaN. ``fft_stage`` takes the twin
for tensors on the CPU and launches the kernel (or raises) otherwise. The
reference kernel's split real/imaginary planes stay in the parity tests;
here complex values are interleaved.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    Kernel,
    require_cuda_tensors,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
FFT_STAGE = Kernel("fft_stage", {
    # x, stage, tw, out, P, B, n, digits, reverse, stream
    "fft_stage": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
})


def digit_reverse(n: int, digits: int, device) -> torch.Tensor:
    """Base-4 digit-reversed index permutation of ``n = 4**digits``."""
    i = torch.arange(n, device=device)
    out = torch.zeros_like(i)
    for _ in range(digits):
        out = out * 4 + i % 4
        i = i // 4
    return out


def _check(x, stage, tw) -> int:
    if x.dim() != 3 or x.dtype != torch.complex64 \
            or tw.dtype != torch.complex64:
        raise TypeError(f"fft_stage: x must be [P, B, n] complex64 and tw "
                        f"complex64, got {tuple(x.shape)} {x.dtype}, "
                        f"{tw.dtype}")
    p, _, n = x.shape
    digits = tw.shape[0]
    if tuple(stage.shape) != (p,) or tuple(tw.shape) != (digits, n) \
            or n != 4 ** digits:
        raise ValueError(f"fft_stage: stage {tuple(stage.shape)} / tw "
                         f"{tuple(tw.shape)} do not match x {tuple(x.shape)}")
    return digits


def stage_plain(x, stage, tw, reverse: bool = False):
    """The kernel's arithmetic in plain PyTorch, on real/imaginary parts as
    the reference kernel writes it."""
    digits = _check(x, stage, tw)
    p, b, n = x.shape
    xf = torch.view_as_real(x.contiguous())                  # [P, B, n, 2]
    out = torch.full_like(xf, float("nan"))
    for s in range(digits):
        rows = (stage == s).nonzero().flatten()
        if rows.numel() == 0:
            continue
        v = xf[rows]
        if reverse and s == 0:
            v = v[:, :, digit_reverse(n, digits, x.device)]
        xr, xi = v[..., 0], v[..., 1]
        twr, twi = tw[s].real, tw[s].imag
        yr = xr * twr - xi * twi
        yi = xr * twi + xi * twr
        quarter = 4 ** s
        shape = (rows.numel(), b, n // (4 * quarter), 4, quarter)
        a_r, b_r, c_r, d_r = yr.reshape(shape).unbind(3)
        a_i, b_i, c_i, d_i = yi.reshape(shape).unbind(3)
        # radix-4 butterfly: t3 = (b - d) * (-1j)
        t0r, t0i = a_r + c_r, a_i + c_i
        t1r, t1i = a_r - c_r, a_i - c_i
        t2r, t2i = b_r + d_r, b_i + d_i
        t3r, t3i = b_i - d_i, -(b_r - d_r)
        o_r = torch.stack([t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r], 3)
        o_i = torch.stack([t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i], 3)
        out[rows] = torch.stack([o_r.reshape(-1, b, n),
                                 o_i.reshape(-1, b, n)], -1)
    return torch.view_as_complex(out)


def stage_cuda(x, stage, tw, reverse: bool = False):
    """One launch of the CUDA kernel over all P row blocks."""
    require_cuda_tensors("fft_stage", x, stage, tw)
    digits = _check(x, stage, tw)
    p, b, n = x.shape
    x = x.contiguous()
    stage = stage.to(torch.int32).contiguous()
    tw = tw.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = FFT_STAGE.lib().fft_stage(
        x.data_ptr(), stage.data_ptr(), tw.data_ptr(), out.data_ptr(),
        p, b, n, digits, int(reverse), stream_handle(x.device))
    FFT_STAGE.check(err)
    FFT_STAGE.launches += 1
    return out


def fft_stage(x, stage, tw, reverse: bool = False):
    """Plain twin for CPU tensors, the CUDA kernel otherwise."""
    if x.device.type == "cpu":
        return stage_plain(x, stage, tw, reverse)
    return stage_cuda(x, stage, tw, reverse)
