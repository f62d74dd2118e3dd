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


def flash_carry_cuda(q, k, v, m, l, acc, q_off, k_off, klen, kv_row=None,
                     *, causal: bool, window: int = 0,
                     normalize: bool = False, out_dtype=None):
    """One launch of the CUDA flash-carry kernel: the tensor-core body for
    bf16 q and K/V with Sq > 1 at head_dim 64 or 128, the key-split
    CUDA-core body otherwise (see the module docstring)."""
    require_cuda_tensors("flash_carry", q, k, v, m, l, acc, q_off, k_off,
                         klen, kv_row)
    bp, sq, h, d = q.shape
    bk, t, kvh, dk = k.shape
    if dk != d or tuple(v.shape) != tuple(k.shape) or h % kvh:
        raise ValueError(f"flash_carry: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if d > HEAD_DIM_MAX:
        raise ValueError(f"flash_carry: head_dim {d} > {HEAD_DIM_MAX}")
    if q.dtype not in DTYPE_CODES or k.dtype not in DTYPE_CODES \
            or v.dtype != k.dtype:
        raise TypeError(f"flash_carry: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    vn = 16 // k.element_size()          # K/V are read as 16-byte vectors
    if d % vn:
        raise ValueError(f"flash_carry: head_dim {d} is not a multiple of "
                         f"{vn}")
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


class _FlashCarry(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd of the plain twin (the
    reference's ``ops._carry_fused`` custom VJP), under the profiler label
    ``flash_carry_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, m, l, acc, q_off, k_off, klen, kv_row, causal,
                window, normalize, out_dtype):
        ctx.save_for_backward(q, k, v, m, l, acc, q_off, k_off, klen, kv_row)
        ctx.opts = dict(causal=causal, window=window, normalize=normalize,
                        out_dtype=out_dtype)
        return flash_carry_cuda(q, k, v, m, l, acc, q_off, k_off, klen,
                                kv_row, **ctx.opts)

    @staticmethod
    def backward(ctx, *grads):
        q, k, v, m, l, acc, q_off, k_off, klen, kv_row = ctx.saved_tensors
        diff = [x.detach().requires_grad_(True) for x in (q, k, v, m, l, acc)]
        with torch.enable_grad(), record_function("flash_carry_backward"):
            outs = flash_carry_plain(*diff, q_off, k_off, klen, kv_row,
                                     **ctx.opts)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs],
                                      diff, [g for _, g in pairs],
                                      allow_unused=True)
        return (*got, None, None, None, None, None, None, None, None)


def flash_carry(q, k, v, m, l, acc, q_off, k_off, klen, kv_row=None, *,
                causal: bool = True, window: int = 0,
                normalize: bool = False, out_dtype=None):
    """Plain twin for CPU tensors, the CUDA kernel otherwise."""
    with count.kernel(FLASH_CARRY.name, lambda: work(
            q, k, m, l, acc, normalize=normalize, out_dtype=out_dtype)):
        if q.device.type == "cpu":
            return flash_carry_plain(q, k, v, m, l, acc, q_off, k_off, klen,
                                     kv_row, causal=causal, window=window,
                                     normalize=normalize,
                                     out_dtype=out_dtype)
        return _FlashCarry.apply(q, k, v, m, l, acc, q_off, k_off, klen,
                                 kv_row, causal, window, normalize,
                                 out_dtype)
