"""Radix-4 DIT FFT on the card: the hand-written CUDA kernels
(``csrc/fft_stage.cu``) and their plain PyTorch twins.

``fft_stage`` runs one stage over row blocks, each at a stage of its own
(one pipeline tick); ``fft_full`` runs the whole transform of every row in
one launch (the shared-memory fft256).

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

``fft_full`` takes ``x [R, n]`` and the same table and returns the FFT of
each row: the digit-reversed load and all D stages, with rows resident in
shared memory. Its twin is D ``stage_plain`` calls, and the kernel equals
it bit for bit. The kernel takes ``4 <= n <= FULL_MAX_N`` (a row must fit
in shared memory); larger transforms run stage by stage
(``core/fft.fft256_radix4``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    Kernel,
    is_fake,
    require_cuda_tensors,
    stream_handle,
)
from repro_torch.roofline import count

_P, _I = ctypes.c_void_p, ctypes.c_int
FFT_STAGE = Kernel("fft_stage", {
    # x, stage, tw, out, P, B, n, digits, reverse, stream
    "fft_stage": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, tw, out, rows, n, digits, stream
    "fft_full": [_P, _P, _P, ctypes.c_longlong, _I, _I, _P],
})
FULL_MAX_N = 4096               # a 32 KB row of shared memory per block


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


# real operations of one radix-4 butterfly with its twiddle multiplies
BUTTERFLY_FLOPS = 34


def work(x, stage, tw):
    """(operations, bytes, type) of one ``fft_stage`` launch: one stage of
    n/4 butterflies per row; x, the stages and the twiddles read once, the
    output written once; fp32."""
    p, b, n = x.shape
    return (BUTTERFLY_FLOPS * (n // 4) * p * b,
            count.nbytes(x, stage, tw, x), "fp32")


def full_work(x, tw):
    """(operations, bytes, type) of one ``fft_full`` launch: all D stages
    of every row; x and the twiddles read once, the output written once."""
    rows, n = x.shape
    return (tw.shape[0] * BUTTERFLY_FLOPS * (n // 4) * rows,
            count.nbytes(x, tw, x), "fp32")


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
    if out.numel() == 0 or is_fake(x, stage, tw):   # fake: a dry run's
        return out
    err = FFT_STAGE.lib().fft_stage(
        x.data_ptr(), stage.data_ptr(), tw.data_ptr(), out.data_ptr(),
        p, b, n, digits, int(reverse), stream_handle(x.device))
    FFT_STAGE.check(err)
    FFT_STAGE.launches += 1
    return out


def fft_stage(x, stage, tw, reverse: bool = False):
    """Plain twin for CPU tensors, the CUDA kernel otherwise."""
    with count.kernel(FFT_STAGE.name, lambda: work(x, stage, tw)):
        if x.device.type == "cpu":
            return stage_plain(x, stage, tw, reverse)
        return stage_cuda(x, stage, tw, reverse)


def _check_full(x, tw) -> int:
    if x.dim() != 2 or x.dtype != torch.complex64 \
            or tw.dtype != torch.complex64:
        raise TypeError(f"fft_full: x must be [R, n] complex64 and tw "
                        f"complex64, got {tuple(x.shape)} {x.dtype}, "
                        f"{tw.dtype}")
    n, digits = x.shape[1], tw.shape[0]
    if tuple(tw.shape) != (digits, n) or n != 4 ** digits:
        raise ValueError(f"fft_full: tw {tuple(tw.shape)} does not match x "
                         f"{tuple(x.shape)}")
    return digits


def fft_full_plain(x, tw):
    """The whole transform as the kernel computes it: D ``stage_plain``
    calls, the first loading digit-reversed."""
    digits = _check_full(x, tw)
    y = x.reshape(1, *x.shape)
    for s in range(digits):
        stage = torch.full((1,), s, dtype=torch.int32, device=x.device)
        y = stage_plain(y, stage, tw, reverse=(s == 0))
    return y[0]


def fft_full_cuda(x, tw):
    """One launch of the CUDA kernel over all rows."""
    require_cuda_tensors("fft_full", x, tw)
    digits = _check_full(x, tw)
    rows, n = x.shape
    if n > FULL_MAX_N:
        raise ValueError(f"fft_full: {n} points > {FULL_MAX_N} do not fit "
                         f"in shared memory; run the stages one by one")
    x = x.contiguous()
    tw = tw.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0 or is_fake(x, tw):     # fake: a dry run's shapes
        return out
    err = FFT_STAGE.lib().fft_full(x.data_ptr(), tw.data_ptr(),
                                   out.data_ptr(), rows, n, digits,
                                   stream_handle(x.device))
    FFT_STAGE.check(err)
    FFT_STAGE.launches += 1
    return out


def fft_full(x, tw):
    """Plain twin for CPU tensors, the CUDA kernel otherwise."""
    with count.kernel(FFT_STAGE.name, lambda: full_work(x, tw)):
        if x.device.type == "cpu":
            return fft_full_plain(x, tw)
        return fft_full_cuda(x, tw)
