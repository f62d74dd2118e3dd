"""Online-softmax attention with carried state: the hand-written CUDA
kernel (``csrc/flash_carry.cu``) and its plain PyTorch twin.

``flash_carry`` folds one K/V block into the carried fp32 state
``(m, l, acc)`` of every query row, the per-hop consume of ring attention:

  q          [B', Sq, H, D]  (fp32 or bf16; any strides, last dim contiguous)
  k, v       [Bk, T, Kv, D]  (fp32 or bf16; k and v share strides)
  m, l       [B', H, Sq] fp32;  acc [B', H, Sq, D] fp32
  q_off, k_off, klen [B'] int: query i of row b sits at q_off[b] + i and
             key j at k_off[b] + j; a key counts iff its position is below
             klen[b] (and, when causal, not after the query; with a window,
             less than ``window`` behind it)
  kv_row     [B'] int or None: the K/V row each query row reads (None: row b
             reads row b), so the ring decode reads its resident cache
             shard in place

Query head h pairs with KV head h // (H / Kv). Masked scores take the
finite sentinel -1e30, as the reference does. With ``normalize`` the third
output is ``acc / max(l, 1e-30)`` in ``out_dtype`` instead of ``acc``.
Tensors on the CPU take the plain twin; CUDA tensors launch the kernel or
raise.

Its gradient is a kernel of its own, ``csrc/flash_carry_bwd.cu`` (the
reference's custom VJP, ``jax.vjp`` of its oracle), beside its plain twin
``flash_carry_backward_plain``, a closed-form gradient. ``flash_carry``
goes through ``_FlashCarry`` on every device: forward and backward take
the kernels for CUDA tensors and the twins for CPU tensors, and each
reports its launch to the roofline counter.

The kernel has two bodies. bf16 q and K/V with more than one query at
head_dim 64 or 128 (the ring prefill and training hops) take the
tensor-core body (``mma.sync``; at head_dim 64 with an unmasked path for
tiles every row sees and exp2 on the special-function unit); everything
else (decode's single query, any fp32 operand, other head dims up to
``HEAD_DIM_MAX``) takes the key-split CUDA-core body.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.profiler import record_function

from repro_torch.kernels._build import (
    Kernel,
    is_fake,
    require_cuda_tensors,
    stream_handle,
)
from repro_torch.roofline import count

NEG_INF = -1e30
HEAD_DIM_MAX = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_CARRY = Kernel("flash_carry", {
    "flash_carry": [
        _P, _L, _L, _L, _I,             # q, q strides, q dtype
        _P, _P, _L, _L, _L, _I,         # k, v, kv strides, kv dtype
        _P, _I, _P, _P, _P,             # kv_row, T, q_off, k_off, klen
        _P, _P, _P, _P, _P, _P, _I,     # m, l, acc in; m, l, o out; o dtype
        _I, _I, _I, _I, _I,             # B', H, Kv, Sq, D
        _I, _I, _I, ctypes.c_float,     # causal, window, normalize, scale
        _P,                             # stream
    ],
})
FLASH_CARRY_BWD = Kernel("flash_carry_bwd", {
    "flash_carry_bwd": [
        _P, _L, _L, _L, _I,             # q, q strides, q dtype
        _P, _P, _L, _L, _L, _I,         # k, v, kv strides, kv dtype
        _P, _P, _P, _I,                 # kv_row, order, start, T
        _P, _P, _P,                     # q_off, k_off, klen
        _P, _P, _P, _P, _P, _P,         # m, l, acc; m_new, l_new, acc_new
        _P, _P, _P,                     # g_m, g_l, g_acc
        _P, _P, _P, _P, _P, _P,         # dq, dk, dv; dm, dl, dacc
        _P, _P, _P, _P,                 # scratch: tie max, tie w, g16, flags
        _I, _I, _I, _I, _I, _I,         # B', Bk, H, Kv, Sq, D
        _I, _I, ctypes.c_float,         # causal, window, scale
        _I, _P, _P,                     # pass B's split: nsplit, shares, partials
        _P,                             # stream
    ],
    "flash_carry_bwd_uses_mma": [_I, _I, _I, _I],
    "flash_carry_bwd_keys_resident": [_I, _P],
})
BWD_TILE = 64        # tensor-core backward: pass A's query rows, pass B's keys
BWD_SHARE_ITEMS = 4  # the fewest query tiles a split share takes on average
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def key_mask(q_off, k_off, klen, sq: int, t: int, *, causal: bool,
             window: int):
    """[B', Sq, T] bool: which keys each query row may attend to."""
    dev = q_off.device
    qp = q_off.long()[:, None] + torch.arange(sq, device=dev)    # [B', Sq]
    kp = k_off.long()[:, None] + torch.arange(t, device=dev)     # [B', T]
    mask = (kp < klen.long()[:, None])[:, None, :].expand(-1, sq, -1)
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if window:
        mask = mask & (qp[:, :, None] - kp[:, None, :] < window)
    return mask


def work(q, k, m, l, acc, *, normalize: bool = False, out_dtype=None,
         pairs: int | None = None, keys: int | None = None):
    """(operations, bytes, type) of one launch: 4·D operations per
    (query, head, key) pair (the two products Q·Kᵀ and P·V); the queries,
    the K and V of the keys read, the state in and the state out.
    ``pairs`` (query, key) and ``keys`` (query row, key) default to every
    pair and key of the launch; a caller that holds the offsets' values
    passes the live ones (``key_mask``)."""
    bp, sq, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    pairs = bp * sq * t if pairs is None else pairs
    keys = bp * t if keys is None else keys
    out_size = (out_dtype or q.dtype).itemsize if normalize else 4
    moved = (count.nbytes(q, m, l, acc) + keys * kvh * d * 2 * k.itemsize
             + m.numel() * 4 * 2 + acc.numel() * out_size)
    kind = "bf16" if q.dtype == k.dtype == torch.bfloat16 else "fp32"
    return 4 * d * h * pairs, moved, kind


def backward_work(q, k, m, acc, *, pairs: int | None = None):
    """(operations, bytes, type) of one backward launch: 12·D operations
    per (query, head, key) pair, as the reference's VJP counts them (its
    oracle's two products recomputed, four more for the gradients); each
    input read once (q, K, V, the state, the saved outputs, the
    cotangents) and each output written once (dq, dK, dV, the state's
    gradients). ``pairs`` defaults to every pair of the launch."""
    bp, sq, h, d = q.shape
    t = k.shape[1]
    pairs = bp * sq * t if pairs is None else pairs
    moved = (2 * count.nbytes(q) + 4 * count.nbytes(k)
             + 8 * m.numel() * 4 + 4 * acc.numel() * 4)
    kind = "bf16" if q.dtype == k.dtype == torch.bfloat16 else "fp32"
    return 12 * d * h * pairs, moved, kind


def backward_nsplit(bp: int, bk: int, t: int, kvh: int, rows: int,
                    resident: int) -> int:
    """Pass B's shares a key tile (tensor-core body) for B' query rows, Bk
    K/V rows of T keys, Kv KV heads and ``rows`` flattened query rows a
    (query row, KV head): 1 where its Bk·Kv·⌈T/64⌉ blocks fill two waves
    of the card's ``resident`` blocks; else enough shares for about four
    waves, at most 16 and with at least ``BWD_SHARE_ITEMS`` query tiles a
    share on average (a shorter share costs more in its partials than it
    gains in fill)."""
    base = bk * kvh * -(-t // BWD_TILE)
    if base == 0 or base >= 2 * resident:
        return 1
    cap = min(16, bp * -(-rows // BWD_TILE) // (bk * BWD_SHARE_ITEMS))
    return max(1, min(cap, -(-4 * resident // base)))


def backward_shares(start, ntile: int, nsplit: int):
    """[Bk, nsplit + 1] int32 from ``start`` [Bk + 1] (the first of each
    K/V row's query rows in ``order``): share s of K/V row kr takes its
    items [shares[kr, s], shares[kr, s + 1]), item n being query tile n %
    ntile of the (n // ntile)-th query row that reads kr; contiguous, in
    order, and as even as whole items allow."""
    n = (start[1:] - start[:-1]).long() * ntile
    s = torch.arange(nsplit + 1, device=start.device)
    return (n[:, None] * s[None, :] // nsplit).to(torch.int32).contiguous()


_RESIDENT: dict = {}


def backward_split(q, k) -> int:
    """``backward_nsplit`` for one launch on q's card: its resident blocks
    of pass B from the occupancy the library reports (1 for the CUDA-core
    body, which has no split)."""
    bp, sq, h, d = q.shape
    bk, t, kvh, _ = k.shape
    lib = FLASH_CARRY_BWD.lib()
    if not lib.flash_carry_bwd_uses_mma(DTYPE_CODES[q.dtype],
                                        DTYPE_CODES[k.dtype], sq, d):
        return 1
    key = (q.device.index, d)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(q.device):
            FLASH_CARRY_BWD.check(lib.flash_carry_bwd_keys_resident(
                d, ctypes.byref(out)))
        _RESIDENT[key] = out.value
    return backward_nsplit(bp, bk, t, kvh, h // kvh * sq, _RESIDENT[key])


def backward_blocks(q, k, nsplit: int) -> dict:
    """Blocks of each pass of one tensor-core backward launch (as
    ``csrc/flash_carry_bwd.cu``'s ``launch_mma`` sizes them): the fp32
    preamble (256 threads, D/4 a row), pass A, pass B and, when split,
    the sum of its partials (256 threads, 4 elements each)."""
    bp, sq, h, d = q.shape
    bk, t, kvh, _ = k.shape
    out = {"prep": -(-bp * h * sq // (256 // (d // 4))),
           "rows": -(-(h // kvh * sq) // BWD_TILE) * kvh * bp,
           "keys": -(-t // BWD_TILE) * nsplit * kvh * bk}
    if nsplit > 1:
        out["sum"] = -(-bk * t * kvh * d // (4 * 256))
    return out


def flash_carry_plain(q, k, v, m, l, acc, q_off, k_off, klen, kv_row=None,
                      *, causal: bool, window: int = 0,
                      normalize: bool = False, out_dtype=None):
    """The kernel's function in plain PyTorch: one online-softmax merge
    over the whole block (equal to the kernel's per-tile merges)."""
    if kv_row is not None:
        k, v = k[kv_row.long()], v[kv_row.long()]
    bp, sq, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    q5 = q.float().reshape(bp, sq, kvh, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", q5, k.float()) * scale
    s = s.reshape(bp, h, sq, t)
    mask = key_mask(q_off, k_off, klen, sq, t, causal=causal, window=window)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgst,btkd->bkgsd", p.reshape(bp, kvh, g, sq, t),
                      v.float()).reshape(bp, h, sq, d)
    acc_new = acc * corr[..., None] + pv
    if normalize:
        out = acc_new / torch.clamp(l_new, min=1e-30)[..., None]
        return m_new, l_new, out.to(out_dtype or q.dtype)
    return m_new, l_new, acc_new


def _check_operands(name: str, q, k, v) -> int:
    """Raise unless the kernels take q, K and V (shapes, types, head_dim);
    returns how many K/V elements make the 16-byte vectors they are read
    as."""
    h, d = q.shape[2:]
    kvh, dk = k.shape[2:]
    if dk != d or tuple(v.shape) != tuple(k.shape) or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if d > HEAD_DIM_MAX:
        raise ValueError(f"{name}: head_dim {d} > {HEAD_DIM_MAX}")
    if q.dtype not in DTYPE_CODES or k.dtype not in DTYPE_CODES \
            or v.dtype != k.dtype:
        raise TypeError(f"{name}: unsupported dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    vn = 16 // k.element_size()
    if d % vn:
        raise ValueError(f"{name}: head_dim {d} is not a multiple of {vn}")
    return vn


def flash_carry_cuda(q, k, v, m, l, acc, q_off, k_off, klen, kv_row=None,
                     *, causal: bool, window: int = 0,
                     normalize: bool = False, out_dtype=None):
    """One launch of the CUDA flash-carry kernel: the tensor-core body for
    bf16 q and K/V with Sq > 1 at head_dim 64 or 128, the key-split
    CUDA-core body otherwise (see the module docstring)."""
    require_cuda_tensors("flash_carry", q, k, v, m, l, acc, q_off, k_off,
                         klen, kv_row)
    bp, sq, h, d = q.shape
    bk, t, kvh, _ = k.shape
    vn = _check_operands("flash_carry", q, k, v)
    if is_fake(q, k, v, m, l, acc):             # a dry run's shapes
        o_dt = (out_dtype or q.dtype) if normalize else torch.float32
        return (torch.empty_like(m, dtype=torch.float32),
                torch.empty_like(l, dtype=torch.float32),
                torch.empty((bp, h, sq, d), dtype=o_dt, device=q.device))
    # the tensor-core body reads bf16 q as pairs: even strides, 4-byte start
    if q.stride(-1) != 1 or (q.dtype == torch.bfloat16 and (
            any(st % 2 for st in q.stride()[:3]) or q.data_ptr() % 4)):
        q = q.clone(memory_format=torch.contiguous_format)
    if k.stride(-1) != 1 or k.stride() != v.stride() \
            or any(st % vn for st in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        k, v = k.contiguous(), v.contiguous()
    out_dtype = (out_dtype or q.dtype) if normalize else torch.float32
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"flash_carry: unsupported output dtype {out_dtype}")
    dev = q.device
    if kv_row is None:
        if bk != bp:
            raise ValueError("flash_carry: kv_row is needed when K/V rows "
                             "differ from query rows")
        kv_row = torch.arange(bp, device=dev)
    ints = [x.to(torch.int32).contiguous() for x in (kv_row, q_off, k_off,
                                                      klen)]
    for x in ints:
        if tuple(x.shape) != (bp,):
            raise ValueError(f"flash_carry: per-row ints must be [{bp}], "
                             f"got {tuple(x.shape)}")
    m = m.float().contiguous()
    l = l.float().contiguous()
    acc = acc.float().contiguous()
    if acc.data_ptr() % 16:                 # read as 16-byte vectors
        acc = acc.clone()
    m_o = torch.empty_like(m)
    l_o = torch.empty_like(l)
    o = torch.empty((bp, h, sq, d), dtype=out_dtype, device=dev)
    if bp == 0 or sq == 0:
        return m_o, l_o, o
    kv_row, q_off, k_off, klen = ints
    err = FLASH_CARRY.lib().flash_carry(
        q.data_ptr(), *q.stride()[:3], DTYPE_CODES[q.dtype],
        k.data_ptr(), v.data_ptr(), *k.stride()[:3], DTYPE_CODES[k.dtype],
        kv_row.data_ptr(), t, q_off.data_ptr(), k_off.data_ptr(),
        klen.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        m_o.data_ptr(), l_o.data_ptr(), o.data_ptr(), DTYPE_CODES[out_dtype],
        bp, h, kvh, sq, d, int(causal), int(window), int(normalize),
        1.0 / math.sqrt(d), stream_handle(dev))
    FLASH_CARRY.check(err)
    FLASH_CARRY.launches += 1
    return m_o, l_o, o


def flash_carry_backward_plain(q, k, v, m, l, acc, q_off, k_off, klen,
                               kv_row, m_new, l_new, acc_new, g_m, g_l,
                               g_acc, *, causal: bool, window: int = 0):
    """The gradient of ``flash_carry_plain`` (``normalize=False``) in
    closed form: (dq, dk, dv, dm, dl, dacc) for the cotangents (g_m, g_l,
    g_acc) of its outputs (m_new, l_new, acc_new), a None cotangent
    counting as zero. ``m_new = maximum(m, amax(s))`` passes ``r = g_m -
    g_l l_new - g_acc . acc_new`` on as torch and JAX do: all to m where m
    exceeds the block's max, split equally among the scores that tie the
    max where it exceeds m, half to each side where they are equal."""
    rows = None if kv_row is None else kv_row.long()
    kk, vv = (k, v) if rows is None else (k[rows], v[rows])
    bp, sq, h, d = q.shape
    t, kvh = kk.shape[1], kk.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    g_m = torch.zeros_like(m_new) if g_m is None else g_m.float()
    g_l = torch.zeros_like(l_new) if g_l is None else g_l.float()
    g_acc = torch.zeros_like(acc_new) if g_acc is None else g_acc.float()
    q5 = q.float().reshape(bp, sq, kvh, g, d)
    kf, vf = kk.float(), vv.float()
    s = torch.einsum("bskgd,btkd->bkgst", q5, kf).reshape(bp, h, sq, t) \
        * scale
    mask = key_mask(q_off, k_off, klen, sq, t, causal=causal,
                    window=window)[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    ga5 = g_acc.reshape(bp, kvh, g, sq, d)
    dp = torch.einsum("bkgsd,btkd->bkgst", ga5, vf).reshape(bp, h, sq, t) \
        + g_l[..., None]
    # the max route: the block's max against the carried m
    r = g_m - g_l * l_new - (g_acc * acc_new).sum(dim=-1)
    big = s.amax(dim=-1)
    to_s = torch.where(big > m, 1.0, torch.where(big == m, 0.5, 0.0))
    ties = s == big[..., None]
    w = to_s * r / ties.sum(dim=-1)
    ds = p * dp + torch.where(ties, w[..., None], 0.0)
    ds5 = torch.where(mask, ds, 0.0).reshape(bp, kvh, g, sq, t)
    dq = torch.einsum("bkgst,btkd->bskgd", ds5, kf).reshape(bp, sq, h, d) \
        * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds5, q5) * scale
    dv = torch.einsum("bkgst,bkgsd->btkd", p.reshape(bp, kvh, g, sq, t),
                      ga5)
    if rows is not None:                # query rows sharing a K/V row add up
        dk = torch.zeros(k.shape, device=k.device).index_add_(0, rows, dk)
        dv = torch.zeros(v.shape, device=v.device).index_add_(0, rows, dv)
    dm = corr * (g_l * l + (g_acc * acc).sum(dim=-1)) + (1.0 - to_s) * r
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dm, g_l * corr,
            g_acc * corr[..., None])


def flash_carry_backward_cuda(q, k, v, m, l, acc, q_off, k_off, klen,
                              kv_row, m_new, l_new, acc_new, g_m, g_l,
                              g_acc, *, causal: bool, window: int = 0):
    """One launch of the backward kernel: the tensor-core body for bf16 q
    and K/V with Sq > 1 at head_dim 64 or 128, the CUDA-core body
    otherwise. Query rows are grouped by the K/V row they read (a stable
    argsort), so pass B sums each K/V row's gradients over them in a fixed
    order; where its blocks would not fill the card it splits each key
    tile's items into ``backward_split`` shares (``backward_shares``),
    whose fp32 partials the kernel sums in share order."""
    require_cuda_tensors("flash_carry_bwd", q, k, v, m, l, acc, q_off,
                         k_off, klen, kv_row, m_new, l_new, acc_new, g_m,
                         g_l, g_acc)
    bp, sq, h, d = q.shape
    bk, t, kvh, _ = k.shape
    vn = _check_operands("flash_carry_bwd", q, k, v)
    if tuple(acc_new.shape) != (bp, h, sq, d):
        raise ValueError("flash_carry_bwd: the saved acc_new is "
                         f"{tuple(acc_new.shape)}, not {(bp, h, sq, d)}")
    dev = q.device
    outs = (torch.empty((bp, sq, h, d), dtype=q.dtype, device=dev),
            torch.empty((bk, t, kvh, d), dtype=k.dtype, device=dev),
            torch.empty((bk, t, kvh, d), dtype=v.dtype, device=dev),
            torch.empty((bp, h, sq), dtype=torch.float32, device=dev),
            torch.empty((bp, h, sq), dtype=torch.float32, device=dev),
            torch.empty((bp, h, sq, d), dtype=torch.float32, device=dev))
    if is_fake(q, k, v, m, l, acc, m_new, l_new, acc_new):
        return outs
    if bp == 0 or sq == 0:              # no query reads a key
        outs[1].zero_()
        outs[2].zero_()
        return outs
    if kv_row is None:
        if bk != bp:
            raise ValueError("flash_carry_bwd: kv_row is needed when K/V "
                             "rows differ from query rows")
        kv_row = torch.arange(bp, device=dev)
    ints = [x.to(torch.int32).contiguous() for x in (kv_row, q_off, k_off,
                                                      klen)]
    for x in ints:
        if tuple(x.shape) != (bp,):
            raise ValueError(f"flash_carry_bwd: per-row ints must be "
                             f"[{bp}], got {tuple(x.shape)}")
    kv_row, q_off, k_off, klen = ints
    order = torch.argsort(kv_row, stable=True).to(torch.int32)
    start = torch.zeros(bk + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(torch.bincount(kv_row, minlength=bk)[:bk], 0)
    # q rows are copied as 16-byte vectors
    if q.stride(-1) != 1 or any(st % 8 for st in q.stride()[:3]) \
            or q.data_ptr() % 16:
        q = q.contiguous()
        if q.data_ptr() % 16:
            q = q.clone()
    if k.stride(-1) != 1 or k.stride() != v.stride() \
            or any(st % vn for st in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        k, v = k.contiguous(), v.contiguous()

    def state(x, shape):
        x = torch.zeros(shape, device=dev) if x is None else \
            x.float().contiguous()
        return x.clone() if x.data_ptr() % 16 else x

    sh, ash = (bp, h, sq), (bp, h, sq, d)
    m, l, m_new, l_new, g_m, g_l = (state(x, sh) for x in (
        m, l, m_new, l_new, g_m, g_l))
    acc, acc_new, g_acc = (state(x, ash) for x in (acc, acc_new, g_acc))
    dq, dk, dv, dm, dl, dacc = outs
    lib = FLASH_CARRY_BWD.lib()
    mma = lib.flash_carry_bwd_uses_mma(DTYPE_CODES[q.dtype],
                                       DTYPE_CODES[k.dtype], sq, d)
    tie_max = torch.empty(sh, device=dev)
    tie_w = torch.empty(sh, device=dev)
    g16 = torch.empty(ash if mma else (8,), dtype=torch.bfloat16, device=dev)
    tiles = (h // kvh * sq + BWD_TILE - 1) // BWD_TILE   # 64-row tiles
    flags = torch.empty((bp * kvh * tiles,), dtype=torch.int32, device=dev)
    nsplit, shares, part = 1, None, None
    if mma:
        nsplit = backward_split(q, k)
        shares = backward_shares(start, tiles, nsplit)
        if nsplit > 1:
            part = torch.empty((2, nsplit, bk, t, kvh, d), device=dev)
    err = lib.flash_carry_bwd(
        q.data_ptr(), *q.stride()[:3], DTYPE_CODES[q.dtype],
        k.data_ptr(), v.data_ptr(), *k.stride()[:3], DTYPE_CODES[k.dtype],
        kv_row.data_ptr(), order.data_ptr(), start.data_ptr(), t,
        q_off.data_ptr(), k_off.data_ptr(), klen.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_new.data_ptr(),
        l_new.data_ptr(), acc_new.data_ptr(), g_m.data_ptr(),
        g_l.data_ptr(), g_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dm.data_ptr(), dl.data_ptr(), dacc.data_ptr(),
        tie_max.data_ptr(), tie_w.data_ptr(), g16.data_ptr(),
        flags.data_ptr(), bp, bk, h, kvh, sq, d, int(causal), int(window),
        1.0 / math.sqrt(d), nsplit,
        None if shares is None else shares.data_ptr(),
        None if part is None else part.data_ptr(), stream_handle(dev))
    FLASH_CARRY_BWD.check(err)
    FLASH_CARRY_BWD.launches += 1
    return outs


def flash_carry_backward(q, k, v, m, l, acc, q_off, k_off, klen, kv_row,
                         m_new, l_new, acc_new, g_m, g_l, g_acc, *,
                         causal: bool, window: int = 0):
    """The backward twin for CPU tensors, the backward kernel otherwise,
    under the profiler label ``flash_carry_backward``."""
    with count.kernel(FLASH_CARRY_BWD.name,
                      lambda: backward_work(q, k, m, acc)), \
            record_function("flash_carry_backward"):
        bwd = flash_carry_backward_plain if q.device.type == "cpu" \
            else flash_carry_backward_cuda
        return bwd(q, k, v, m, l, acc, q_off, k_off, klen, kv_row, m_new,
                   l_new, acc_new, g_m, g_l, g_acc, causal=causal,
                   window=window)


class _FlashCarry(torch.autograd.Function):
    """Forward: the CUDA kernel, or the twin for CPU tensors. Backward:
    ``flash_carry_backward`` (the backward kernel, or its twin), the
    reference's ``ops._carry_fused`` custom VJP. The reference defines no
    gradient for ``normalize=True`` (``_carry_fused`` fixes
    ``normalize=False``), so its backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, m, l, acc, q_off, k_off, klen, kv_row, causal,
                window, normalize, out_dtype):
        ctx.opts = dict(causal=causal, window=window, normalize=normalize,
                        out_dtype=out_dtype)
        fwd = flash_carry_plain if q.device.type == "cpu" \
            else flash_carry_cuda
        outs = fwd(q, k, v, m, l, acc, q_off, k_off, klen, kv_row,
                   **ctx.opts)
        ctx.save_for_backward(q, k, v, m, l, acc, q_off, k_off, klen, kv_row,
                              *outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        q, k, v, m, l, acc, q_off, k_off, klen, kv_row, *outs = \
            ctx.saved_tensors
        if ctx.opts["normalize"]:
            raise NotImplementedError(
                "flash_carry defines no gradient for normalize=True")
        got = flash_carry_backward(
            q, k, v, m, l, acc, q_off, k_off, klen, kv_row, *outs, *grads,
            causal=ctx.opts["causal"], window=ctx.opts["window"])
        return (*got, None, None, None, None, None, None, None, None)


def flash_carry(q, k, v, m, l, acc, q_off, k_off, klen, kv_row=None, *,
                causal: bool = True, window: int = 0,
                normalize: bool = False, out_dtype=None):
    """Plain twin for CPU tensors, the CUDA kernel otherwise, through
    ``_FlashCarry`` on both."""
    with count.kernel(FLASH_CARRY.name, lambda: work(
            q, k, m, l, acc, normalize=normalize, out_dtype=out_dtype)):
        return _FlashCarry.apply(q, k, v, m, l, acc, q_off, k_off, klen,
                                 kv_row, causal, window, normalize,
                                 out_dtype)
