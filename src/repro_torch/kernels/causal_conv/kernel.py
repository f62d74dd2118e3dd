"""The Mamba2 layer's depthwise causal conv with its bias and SiLU: the
hand-written CUDA kernel pair (``csrc/causal_conv.cu``,
``csrc/causal_conv_bwd.cu``) and their plain PyTorch twins.

Both compute ``silu(sum_i w[i] * x[t - (K-1-i)] + bias)`` over x [B,S,C]
(any strides), w [K,C] and bias [C] in x's type, rows before 0 zero, in
the reference's rounding (``repro/models/ssm.py::_causal_conv``: the taps
summed in order from zero, each product and partial sum rounded to the
activation type, then the bias, then SiLU). No Pallas kernel stands behind
them: the reference's conv is plain jnp. The kernels read the conv columns
of the layer's input projection in place, as one strided view of it.

``causal_conv`` goes through ``_CausalConv`` on every device: its forward
takes the kernel for CUDA tensors and the twin ``causal_conv_plain`` for
CPU tensors, its backward the backward kernel or its closed-form twin
``causal_conv_backward_plain``. Each kernel has two bodies behind one
launch, chosen by :func:`conv_vector` from the shape, the strides and the
data pointers: 16 bytes of channels a thread for rows on 16-byte
boundaries, one channel a thread otherwise.
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CAUSAL_CONV = Kernel("causal_conv", {
    # x, batch stride, row stride, w, bias, out, B, S, C, K, dtype, tile,
    # vector (0: the generic body), stream
    "causal_conv": [_P, _L, _L, _P, _P, _P] + [_I] * 7 + [_P],
    # K, dtype, vector, out: the body's resident blocks on the current card
    "causal_conv_resident": [_I] * 3 + [_P],
})
CAUSAL_CONV_BWD = Kernel("causal_conv_bwd", {
    # x, batch stride, row stride, w, bias, g, dx, dw, dbias, part (fp32
    # [B * ceil(S / tile), K + 1, C]), B, S, C, K, dtype, tile, vector,
    # stream
    "causal_conv_bwd": [_P, _L, _L] + [_P] * 7 + [_I] * 7 + [_P],
    "causal_conv_bwd_resident": [_I] * 3 + [_P],
})
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 4
THREADS = 128         # a block of either kernel
VEC_BYTES = 16        # the forward's 16-byte body: 16 bytes of channels
BWD_CHANNELS = 4      # the backward's vector body: 4 channels a thread
TILES = (64, 32, 16, 8)   # rows a thread, largest first (``row_tile``)
# waves of resident blocks a grid should fill: the forward's halo rows are
# loads alone, so it takes short tiles for many threads; the backward
# recomputes K-1 rows of dp a tile, so it takes long ones
WAVES, BWD_WAVES = 8, 2


def conv_vector(shape, strides, itemsize: int, addresses) -> bool:
    """Whether the kernels take their vector body for x of ``shape`` (B, S,
    C) and ``strides`` (in elements; channels contiguous) with the data
    pointers ``addresses``: every row must start on a 16-byte boundary, so
    C and the batch and row strides are whole multiples of 16 bytes (a
    stride of a dimension of size 1 is never stepped) and every pointer
    is 16-byte aligned. The mamba2-1.3b view of the input projection
    (stride 8,512, offset 4,096, C 4,352 in bf16) is."""
    b, s, c = shape
    steps = [st for n, st in ((b, strides[0]), (s, strides[1])) if n > 1]
    return all((n * itemsize) % VEC_BYTES == 0 for n in (c, *steps)) \
        and all(a % VEC_BYTES == 0 for a in addresses)


def row_tile(b: int, s: int, per_row: int, resident: int,
             waves: int = WAVES) -> int:
    """Rows a thread walks, for B x S rows of ``per_row`` threads a row: the
    largest of ``TILES`` whose grid fills ``waves`` waves of the card's
    ``resident`` blocks, else the smallest. Measured on an H100 at
    mamba2-1.3b's shapes (``PERF.md`` §6), the forward is fastest with the
    most threads its tiles allow and the backward with tiles of 64 rows,
    each K-1 halo rows of which are recomputed."""
    for tile in TILES:
        blocks = -(-b * -(-s // tile) * per_row // THREADS)
        if blocks >= waves * resident:
            return tile
    return TILES[-1]


def _check(x, w, bias):
    if x.dim() != 3 or w.dim() != 2 or bias.dim() != 1 \
            or w.shape[1] != x.shape[2] or bias.shape[0] != x.shape[2]:
        raise ValueError(f"causal_conv: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")


def _check_kernel(name: str, x, w, bias):
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype \
            or bias.dtype != x.dtype:
        raise TypeError(f"{name}: x, w and bias must share fp32 or bf16, got "
                        f"{x.dtype}, {w.dtype}, {bias.dtype}")
    if not 1 <= w.shape[0] <= MAX_K:
        raise ValueError(f"{name}: conv width {w.shape[0]} is not in "
                         f"1..{MAX_K}")


def work(x, w, bias):
    """(operations, bytes, type) of one forward launch: K multiply-adds and
    the bias an output element (SiLU not counted); x read once, the output
    written once, w and bias read once; fp32 on the CUDA cores."""
    k = w.shape[0]
    return (2 * k + 1) * x.numel(), count.nbytes(x, x, w, bias), "fp32"


def backward_work(x, w, bias):
    """(operations, bytes, type) of one backward launch: the forward's
    operations again, then per element K multiply-adds for dx, K for dw
    and one add for the bias; x and g read once, dx written once, w and
    bias read and their gradients written once."""
    k = w.shape[0]
    return (6 * k + 2) * x.numel(), count.nbytes(x, x, x, w, bias, w, bias), \
        "fp32"


def conv_pre(x, w, bias):
    """The pre-activation in x's type: the reference's taps and bias."""
    k, s = w.shape[0], x.shape[1]
    y = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xs * w[i][None, None, :]
    return y + bias[None, None, :]


def causal_conv_plain(x, w, bias):
    """Depthwise causal conv1d. x: [B,S,C]; w: [K,C] -> silu(conv(x))."""
    return F.silu(conv_pre(x, w, bias))


def causal_conv_backward_plain(x, w, bias, g):
    """The gradient of ``causal_conv_plain`` in closed form: (dx, dw,
    dbias) in the leaves' types for the cotangent g of its output. With
    pre the forward's pre-activation (in x's type) and dp = g silu'(pre):

      dx[t] = sum_i dp[t + K-1-i] w[i]   (rows below S)
      dw[i] = sum_{b,t} dp[t] x[t - (K-1-i)],  dbias = sum_{b,t} dp[t]

    dp and every sum in fp32 (float64 for float64 x), each gradient
    rounded once, as the backward kernel rounds them."""
    k, s = w.shape[0], x.shape[1]
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    pre = conv_pre(x, w, bias).to(wide)
    sig = torch.sigmoid(pre)
    dp = g.to(wide) * sig * (1 + pre * (1 - sig))
    xf, wf = x.to(wide), w.to(wide)
    dx = torch.zeros_like(dp)
    dw = torch.zeros(w.shape, dtype=wide, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        if shift >= s:
            continue
        dx[:, :s - shift] += dp[:, shift:] * wf[i]
        dw[i] = (dp[:, shift:] * xf[:, :s - shift]).sum((0, 1))
    return dx.to(x.dtype), dw.to(w.dtype), dp.sum((0, 1)).to(bias.dtype)


_RESIDENT: dict = {}


def resident(kern: Kernel, x, k: int, vector: bool) -> int:
    """A body's resident blocks on x's card (from the occupancy the
    runtime reports), asked once per card, type, width and body."""
    code = DTYPE_CODES[x.dtype]
    key = (kern.name, x.device.index, code, k, vector)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        entry = getattr(kern.lib(), f"{kern.name}_resident")
        with torch.cuda.device(x.device):
            kern.check(entry(k, code, int(vector), ctypes.byref(out)))
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _channels_contiguous(x):
    """x itself when its channels are contiguous (the layer's strided view
    of the input projection is), else a contiguous copy."""
    return x if x.stride(-1) == 1 or x.shape[-1] == 1 else x.contiguous()


def causal_conv_cuda(x, w, bias, tile: int = 0):
    """One launch of the forward kernel; x is read in place at its strides.
    ``tile`` forces the rows a thread (0: ``row_tile``'s)."""
    require_cuda_tensors("causal_conv", x, w, bias)
    _check(x, w, bias)
    _check_kernel("causal_conv", x, w, bias)
    b, s, c = x.shape
    k = w.shape[0]
    out = torch.empty(b, s, c, dtype=x.dtype, device=x.device)
    if out.numel() == 0 or is_fake(x, w, bias):     # fake: a dry run's
        return out
    x = _channels_contiguous(x)
    w, bias = w.contiguous(), bias.contiguous()
    size = x.element_size()
    vector = conv_vector(x.shape, x.stride(), size, (
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr()))
    per_row = c * size // VEC_BYTES if vector else c
    tile = tile or row_tile(b, s, per_row,
                            resident(CAUSAL_CONV, x, k, vector))
    err = CAUSAL_CONV.lib().causal_conv(
        x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, s, c, k, DTYPE_CODES[x.dtype],
        tile, int(vector), stream_handle(x.device))
    CAUSAL_CONV.check(err)
    CAUSAL_CONV.launches += 1
    return out


def causal_conv_backward_cuda(x, w, bias, g, tile: int = 0):
    """One launch of the backward kernel (its main pass and the sum of the
    tiles' dw and dbias partials), at x's strides."""
    require_cuda_tensors("causal_conv_bwd", x, w, bias, g)
    _check(x, w, bias)
    _check_kernel("causal_conv_bwd", x, w, bias)
    b, s, c = x.shape
    k = w.shape[0]
    dev = x.device
    outs = (torch.empty(b, s, c, dtype=x.dtype, device=dev),
            torch.empty(w.shape, dtype=w.dtype, device=dev),
            torch.empty(bias.shape, dtype=bias.dtype, device=dev))
    if is_fake(x, w, bias, g):                      # a dry run's shapes
        return outs
    if x.numel() == 0:
        return tuple(o.zero_() for o in outs)
    dx, dw, db = outs
    x = _channels_contiguous(x)
    w, bias = w.contiguous(), bias.contiguous()
    g = g.to(x.dtype).contiguous()
    vector = conv_vector(x.shape, x.stride(), x.element_size(), (
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dx.data_ptr()))
    per_row = c // BWD_CHANNELS if vector else c
    tile = tile or row_tile(b, s, per_row,
                            resident(CAUSAL_CONV_BWD, x, k, vector),
                            BWD_WAVES)
    part = torch.empty(b * -(-s // tile), k + 1, c, dtype=torch.float32,
                       device=dev)
    err = CAUSAL_CONV_BWD.lib().causal_conv_bwd(
        x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
        bias.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), part.data_ptr(), b, s, c, k, DTYPE_CODES[x.dtype],
        tile, int(vector), stream_handle(dev))
    CAUSAL_CONV_BWD.check(err)
    CAUSAL_CONV_BWD.launches += 1
    return outs


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def causal_conv_backward(x, w, bias, g):
    """The backward twin for CPU tensors, the backward kernel otherwise,
    in the span ``causal_conv_backward``."""
    with count.kernel(CAUSAL_CONV_BWD.name,
                      lambda: backward_work(x, w, bias)), \
            trace.span("causal_conv_backward"):
        bwd = causal_conv_backward_plain if _on_cpu(x, w, bias, g) \
            else causal_conv_backward_cuda
        return bwd(x, w, bias, g)


class _CausalConv(torch.autograd.Function):
    """Forward: the CUDA kernel, or the twin for CPU tensors. Backward:
    ``causal_conv_backward`` at the saved inputs (x as the strided view it
    was given)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        fwd = causal_conv_plain if _on_cpu(x, w, bias) else causal_conv_cuda
        return fwd(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        return causal_conv_backward(*ctx.saved_tensors, g)


def causal_conv(x, w, bias):
    """silu(causal conv1d(x) + bias). x: [B,S,C] (any strides); w: [K,C];
    bias: [C]; the output [B,S,C] is contiguous. Plain twin for CPU
    tensors, the CUDA kernels otherwise (mixed devices raise), through
    ``_CausalConv`` on both."""
    with count.kernel(CAUSAL_CONV.name, lambda: work(x, w, bias)):
        return _CausalConv.apply(x, w, bias)
