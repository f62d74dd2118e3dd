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
overflows at realistic ``dt``.

``ssd_chunks`` goes through ``_SSDChunks`` on every device: its forward
takes the kernel for CUDA tensors and the twin for CPU tensors, its
backward the backward kernel (``csrc/ssd_chunks_bwd.cu``) or its closed-form
twin ``ssd_chunks_backward_plain``. The reference has no backward kernel:
its gradient is jnp autodiff of ``repro/models/ssm.ssd_chunked``, which the
backward kernel computes.

The forward kernel has two bodies behind one launch: bf16 inputs run on the
tensor cores (``mma.sync``, with M = (C B^T) * decay * dt and x * w each
split into two bf16 halves, so that the fp32 twin's 1e-4 bound holds), fp32
inputs on the CUDA cores. The backward kernel has the same two bodies.
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
SSD_CHUNKS_BWD = Kernel("ssd_chunks_bwd", {
    # x, dt, a, b, c, gy, gs, ge, dx, ddt, da, db, dc, scratch (db_part,
    # dc_part, rows32, rows64, da_part: ``backward_scratch``), BH, NC, L,
    # P, N, nheads, ngroups, slices, dtype, stream
    "ssd_chunks_bwd": [_P] * 18 + [_I] * 9 + [_P],
    # L, P, N, dtype, out: pass A's resident blocks on the current card
    "ssd_chunks_bwd_resident": [_I] * 4 + [_P],
    # L, P, N, dtype: whether pass A's shared memory holds the shapes
    "ssd_chunks_bwd_takes": [_I] * 4,
})
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128          # the kernel's register micro tiles
BWD_TILE = 64                   # rows of s and of t a tile, in pass A


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


def backward_work(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """(operations, bytes, type) of one backward launch (all its passes).
    Operations: C Bᵀ on the causal triangle once per (group row, chunk);
    per (head row, chunk) the triangles of gy xᵀ, Mᵀ gy, dCB B and dCBᵀ C,
    and the two full products B gsᵀ and x gs. Bytes: the five inputs and
    the three fp32 cotangents read once, the five gradients written once.
    On the tensor cores for bf16."""
    bh, nc, l, p = x.shape
    bg, n = b.shape[0], b.shape[-1]
    tri = l * (l + 1) // 2
    flops = bg * nc * 2 * tri * n + bh * nc * (2 * tri * (2 * p + 2 * n)
                                               + 4 * l * p * n)
    moved = 2 * count.nbytes(x, dt, a, b, c) + 4 * bh * nc * (l * p + p * n + l)
    kind = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    return flops, moved, kind


def backward_plan(bg: int, nc: int, l: int, hpg: int, resident: int, *,
                  tensor_cores: bool = True) -> int:
    """Head slices a group of the backward's pass A, for BG group rows of
    NC chunks of L rows with ``hpg`` heads a group: the fewest whose blocks
    (``backward_grid``) fill two waves of the card's ``resident`` blocks,
    at most one a head. Each block runs its slice's heads in order and
    sums their dCB, so fewer slices mean fewer partial sums to add up
    (``backward_scratch``) and fewer S products, more slices a fuller
    card."""
    tiles = -(-l // BWD_TILE) if tensor_cores else 1
    base = bg * nc * tiles
    return max(1, min(hpg, -(-2 * resident // base)))


def backward_heads(hpg: int, slices: int):
    """[(first, end)] of each slice's heads within a group: contiguous, in
    order and as even as whole heads allow (``slice_of`` in
    ``csrc/ssd_chunks_bwd.cu``)."""
    return [(k * hpg // slices, (k + 1) * hpg // slices)
            for k in range(slices)]


def backward_grid(bg: int, nc: int, l: int, hpg: int, slices: int, *,
                  tensor_cores: bool = True):
    """Pass A's blocks in launch order, each (s tile, group row, chunk,
    first head, end head, t tiles): on the tensor cores one block per (s
    tile, group row, chunk, slice), s tiles slowest (the first have the
    most t tiles: the tiles at or below the diagonal); the CUDA-core body
    one per (group row, chunk, slice), over every tile pair."""
    ns = -(-l // BWD_TILE)
    heads = backward_heads(hpg, slices)
    cells = [(gr, ch, first, end) for gr in range(bg) for ch in range(nc)
             for first, end in heads]
    if not tensor_cores:
        return [(None, gr, ch, first, end, None)
                for gr, ch, first, end in cells]
    return [(st, gr, ch, first, end, tuple(range(st, ns)))
            for st in range(ns) for gr, ch, first, end in cells]


def backward_scratch(bh: int, bg: int, nc: int, l: int, n: int, slices: int,
                     *, tensor_cores: bool = True) -> dict:
    """Shapes of the backward's scratch: the dB and dC partial sums of each
    slice (fp32; dC also of each s tile on the tensor cores), the chunks'
    shares of da (float64) and, on the tensor cores, the per-row arrays
    (fp32: cum, w, v, ddt's first term; float64: Q's column sums, then
    its row sums per s tile)."""
    ns = -(-l // BWD_TILE)
    sparts = ns if tensor_cores else 1
    return {"db_part": (bg, nc, slices, l, n),
            "dc_part": (bg, nc, slices, sparts, l, n),
            "rows32": (4, bh, nc, l) if tensor_cores else (0,),
            "rows64": ((1 + ns) * bh * nc * l,) if tensor_cores else (0,),
            "da_part": (bh, nc)}


_RESIDENT: dict = {}


def backward_resident(x, b) -> int:
    """Pass A's resident blocks on x's card at these shapes (blocks an SM
    times SMs, from the occupancy the library reports)."""
    l, p, n = x.shape[2], x.shape[3], b.shape[-1]
    code = DTYPE_CODES[x.dtype]
    key = (x.device.index, code, l, p, n)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            SSD_CHUNKS_BWD.check(SSD_CHUNKS_BWD.lib().ssd_chunks_bwd_resident(
                l, p, n, code, ctypes.byref(out)))
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def backward_slices(x, b, *, nheads: int, ngroups: int) -> int:
    """``backward_plan`` for one launch on x's card."""
    bh, nc, l, _ = x.shape
    return backward_plan(b.shape[0], nc, l, nheads // ngroups,
                         backward_resident(x, b),
                         tensor_cores=x.dtype == torch.bfloat16)


def ssd_chunks_plain(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """The reference kernel's body batched over (BH, NC), in fp32; in
    float64 for float64 x (the card tests' oracle of the backward kernel,
    with ``cum`` the same fp32 values)."""
    _check(x, dt, a, b, c, nheads, ngroups)
    bh, nc, l, _ = x.shape
    rows = group_rows(bh, nheads, ngroups, x.device)
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(wide)
    dt32 = dt.float()[..., 0]                                 # [BH,NC,L]
    bf, cf = b.to(wide), c.to(wide)
    da = dt32 * a.float().reshape(bh, 1, 1)
    cum = torch.cumsum(da.double(), dim=-1).float().to(wide)
    dtf = dt32.to(wide)
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


def _check_kernel(name: str, x, dt, a, b, c):
    """Raise unless the CUDA kernels take these operands: x, b and c fp32
    or bf16 alike, dt and a fp32, P and N within the register tiles."""
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"{name}: x/b/c must share fp32 or bf16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{name}: dt and a must be fp32, got "
                        f"{dt.dtype}, {a.dtype}")
    p, n = x.shape[-1], b.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"{name}: headdim {p} > {MAX_P} or state {n} > "
                         f"{MAX_N} is not taken by the kernel")


def ssd_chunks_cuda(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """One launch of the CUDA kernel over every (head, chunk)."""
    require_cuda_tensors("ssd_chunks", x, dt, a, b, c)
    _check(x, dt, a, b, c, nheads, ngroups)
    _check_kernel("ssd_chunks", x, dt, a, b, c)
    bh, nc, l, p = x.shape
    n = b.shape[-1]
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


def ssd_chunks_backward_plain(x, dt, a, b, c, gy, gs, ge, *, nheads: int,
                              ngroups: int):
    """The gradient of ``ssd_chunks_plain`` in closed form: (dx, ddt, da,
    db, dc) in the leaves' types for the cotangents (gy, gs, ge) of its
    outputs (y, states, expcum), a None cotangent counting as zero. Per
    head row and chunk, with D the causal decay, CB = C Bᵀ, M = CB ⊙ D ⊙
    dt_s and w_s = exp(cum[L-1] - cum[s]) dt_s:

      dM = tril(gy xᵀ), Q = dM ⊙ M, dCB = dM ⊙ D ⊙ dt_s, u = B gsᵀ
      dx = Mᵀ gy + w ⊙ u,  dC = dCB B,  dB = dCBᵀ C + w ⊙ (x gs)
      v_s = Σ_p x_sp u_sp
      dcum = rowsum(Q) - colsum(Q) - v w + [t = L-1] Σ v w + ge exp(cum)
      R_s = Σ_{t>=s} dcum_t (in float64, as autograd of the float64 cumsum)
      ddt_s = Σ_t dM_ts CB_ts D_ts + v_s exp(cum[L-1] - cum[s]) + a R_s
      da = Σ_chunks Σ_s dt_s R_s

    dB and dC of a group row sum those of its heads. ``da`` is
    ill-conditioned: every R_s sums the dcum of the rows after s, so one
    ulp of a dcum moves ``da`` by about L NC dt ulps. dcum's parts are
    therefore formed and added as autograd of the twin forms and adds them
    (products in its order, the parts in the order its engine sums them),
    which gives autograd's fp32 bits."""
    _check(x, dt, a, b, c, nheads, ngroups)
    bh, nc, l, p = x.shape
    n = b.shape[-1]
    rows = group_rows(bh, nheads, ngroups, x.device)
    xf = x.float()
    dtf = dt.float()[..., 0]                                  # [BH,NC,L]
    bf, cf = b.float()[rows], c.float()[rows]                 # [BH,NC,L,N]
    af = a.float().reshape(bh, 1, 1)
    gy = torch.zeros_like(xf) if gy is None else gy.float()
    gs = torch.zeros(bh, nc, p, n, device=x.device) if gs is None \
        else gs.float()
    ge = torch.zeros_like(dtf) if ge is None else ge.float()[..., 0]
    cum = torch.cumsum((dtf * af).double(), dim=-1).float()
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(
        mask, cum[..., :, None] - cum[..., None, :], float("-inf")))
    cb = torch.matmul(cf, bf.transpose(-1, -2))
    cbd = cb * decay
    m = cbd * dtf[..., None, :]
    tail = torch.exp(cum[..., -1:] - cum)
    # dM = gy xᵀ; above the diagonal it only ever meets D = 0
    dm = torch.matmul(gy, xf.transpose(-1, -2))
    gx = dm * dtf[..., None, :]
    dcb = gx * decay
    q = torch.where(mask, gx * cb * decay, 0.0)   # dM ⊙ M
    u = torch.matmul(gs, bf.transpose(-1, -2)).transpose(-1, -2)
    v = (u * xf).sum(-1)
    vw = v * dtf * tail
    dcum = ge * torch.exp(cum) - vw
    dcum[..., -1] += vw.sum(-1)
    dcum = dcum + (-q).sum(-2) + q.sum(-1)
    r = dcum.double().flip(-1).cumsum(-1).flip(-1).float()
    dx = torch.matmul(m.transpose(-1, -2), gy) + u * (tail * dtf)[..., None]
    dc_h = torch.matmul(dcb, bf)
    db_h = torch.matmul(dcb.transpose(-1, -2), cf) \
        + (tail * dtf)[..., None] * torch.matmul(xf, gs)
    ddt = (dm * cbd).sum(-2) + v * tail + r * af
    da = (r * dtf).sum((1, 2)).reshape(bh, 1, 1, 1)
    db = torch.zeros(b.shape, device=x.device).index_add_(0, rows, db_h)
    dc = torch.zeros(c.shape, device=x.device).index_add_(0, rows, dc_h)
    return (dx.to(x.dtype), ddt[..., None].to(dt.dtype), da.to(a.dtype),
            db.to(b.dtype), dc.to(c.dtype))


def ssd_chunks_backward_cuda(x, dt, a, b, c, gy, gs, ge, *, nheads: int,
                             ngroups: int):
    """One launch of the backward kernel (its passes, ``backward_plan``'s
    head slices): the tensor-core body for bf16, the CUDA-core body for
    fp32. None cotangents are zeros."""
    require_cuda_tensors("ssd_chunks_bwd", x, dt, a, b, c, gy, gs, ge)
    _check(x, dt, a, b, c, nheads, ngroups)
    _check_kernel("ssd_chunks_bwd", x, dt, a, b, c)
    bh, nc, l, p = x.shape
    n = b.shape[-1]
    dev = x.device
    outs = (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty(bh, nc, l, 1, device=dev),
            torch.empty(bh, 1, 1, 1, device=dev),
            torch.empty(b.shape, dtype=b.dtype, device=dev),
            torch.empty(c.shape, dtype=c.dtype, device=dev))
    if is_fake(x, dt, a, b, c, gy, gs, ge):     # a dry run's shapes
        return outs
    if x.numel() == 0:
        return tuple(o.zero_() for o in outs)

    def cot(g, shape):
        return torch.zeros(shape, device=dev) if g is None \
            else g.float().contiguous()

    gy, gs, ge = cot(gy, (bh, nc, l, p)), cot(gs, (bh, nc, p, n)), \
        cot(ge, (bh, nc, l, 1))
    if not SSD_CHUNKS_BWD.lib().ssd_chunks_bwd_takes(
            l, p, n, DTYPE_CODES[x.dtype]):
        raise ValueError(f"ssd_chunks_bwd: chunk {l} at headdim {p} and state "
                         f"{n} does not fit the kernel's shared memory")
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    dx, ddt, da, db, dc = outs
    slices = backward_slices(x, b, nheads=nheads, ngroups=ngroups)
    shapes = backward_scratch(bh, b.shape[0], nc, l, n, slices,
                              tensor_cores=x.dtype == torch.bfloat16)
    wide = {"rows64", "da_part"}
    scratch = {k: torch.empty(shape, device=dev, dtype=torch.float64
                              if k in wide else torch.float32)
               for k, shape in shapes.items()}
    err = SSD_CHUNKS_BWD.lib().ssd_chunks_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        gy.data_ptr(), gs.data_ptr(), ge.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        *(scratch[k].data_ptr() for k in ("db_part", "dc_part", "rows32",
                                          "rows64", "da_part")),
        bh, nc, l, p, n, nheads, ngroups, slices, DTYPE_CODES[x.dtype],
        stream_handle(dev))
    SSD_CHUNKS_BWD.check(err)
    SSD_CHUNKS_BWD.launches += 1
    return outs


def ssd_chunks_backward(x, dt, a, b, c, gy, gs, ge, *, nheads: int,
                        ngroups: int):
    """The backward twin for CPU tensors, the backward kernel otherwise,
    under the profiler label ``ssd_chunks_backward``."""
    with count.kernel(SSD_CHUNKS_BWD.name, lambda: backward_work(
            x, dt, a, b, c, nheads=nheads, ngroups=ngroups)), \
            record_function("ssd_chunks_backward"):
        bwd = ssd_chunks_backward_plain if x.device.type == "cpu" \
            else ssd_chunks_backward_cuda
        return bwd(x, dt, a, b, c, gy, gs, ge, nheads=nheads,
                   ngroups=ngroups)


class _SSDChunks(torch.autograd.Function):
    """Forward: the CUDA kernel, or the twin for CPU tensors. Backward:
    ``ssd_chunks_backward`` (the backward kernel, or its closed-form twin)
    at the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, nheads, ngroups):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.opts = dict(nheads=nheads, ngroups=ngroups)
        fwd = ssd_chunks_plain if x.device.type == "cpu" else ssd_chunks_cuda
        return fwd(x, dt, a, b, c, **ctx.opts)

    @staticmethod
    def backward(ctx, *grads):
        got = ssd_chunks_backward(*ctx.saved_tensors, *grads, **ctx.opts)
        return (*got, None, None)


def ssd_chunks(x, dt, a, b, c, *, nheads: int, ngroups: int):
    """Plain twin for CPU tensors, the CUDA kernel otherwise, through
    ``_SSDChunks`` on both."""
    with count.kernel(SSD_CHUNKS.name, lambda: work(
            x, dt, a, b, c, nheads=nheads, ngroups=ngroups)):
        return _SSDChunks.apply(x, dt, a, b, c, nheads, ngroups)
