"""Kernel twins of the port against the JAX reference.

On the CPU each wrapper takes its plain PyTorch twin; these tests hold the
twins to the reference's Pallas kernels run in interpret mode and to their
jnp oracles, in fp32 at the bounds of ``tests/test_kernels.py``: 1e-5 for
a flash hop, 1e-4 relative for the tile matmul. The CUDA kernels are held
to the twins on the card by ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_reference import ref, to_torch  # noqa: F401 (fixture)

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.kernel import flash_carry
from repro_torch.kernels.systolic_matmul.ops import tile_matmul

FLASH_TOL = 1e-5
MATMUL_RTOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _state(rng, b, h, sq, hd, fresh: bool):
    """(m, l, acc) numpy: the zero state, or one a previous hop left."""
    if fresh:
        return (np.full((b, h, sq), -1e30, np.float32),
                np.zeros((b, h, sq), np.float32),
                np.zeros((b, h, sq, hd), np.float32))
    return (_rand(rng, b, h, sq), np.abs(_rand(rng, b, h, sq)) + 1.0,
            _rand(rng, b, h, sq, hd))


def _close(got, want, tol=FLASH_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


FLASH_CASES = [
    # (b, sq, t, h, kvh, causal, window, q_off, k_off, fresh, hd, bkv)
    pytest.param(2, 8, 12, 4, 2, True, 0, 12, 4, True, 8, 6, id="gqa-causal"),
    pytest.param(2, 8, 12, 4, 2, True, 3, 12, 6, False, 8, 6,
                 id="gqa-window"),
    pytest.param(1, 6, 10, 2, 2, False, 0, 0, 0, False, 8, 5,
                 id="mha-ragged"),
    pytest.param(3, 4, 8, 4, 1, True, 0, 0, 20, True, 8, 4,
                 id="fully-masked"),
    # head_dim 64, the width of zamba2, internvl2 and whisper: a GQA group
    # of 7 whose 40 keys the reference's 16-key block does not tile (it
    # shrinks the block to 10), and MHA whose last 16 keys lie after every
    # query (two fully masked reference blocks)
    pytest.param(1, 16, 40, 14, 2, True, 0, 36, 4, False, 64, 16,
                 id="hd64-gqa7-ragged"),
    pytest.param(2, 8, 24, 4, 4, True, 0, 0, 0, False, 64, 8,
                 id="hd64-mha-masked-tail"),
]


@pytest.mark.parametrize(
    "b,sq,t,h,kvh,causal,window,q_off,k_off,fresh,hd,bkv", FLASH_CASES)
def test_flash_hop_twin_vs_reference(ref, b, sq, t, h, kvh, causal, window,
                                     q_off, k_off, fresh, hd, bkv):
    """Port flash_hop (plain twin) == reference flash_hop (Pallas kernel
    in interpret mode, several KV blocks) == its jnp oracle."""
    from repro.kernels.flash_attention import ops as rops
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, b, sq, h, hd), _rand(rng, b, t, kvh, hd), \
        _rand(rng, b, t, kvh, hd)
    st = _state(rng, b, h, sq, hd, fresh)
    want = rops.flash_hop(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          tuple(map(jnp.asarray, st)), q_offset=q_off,
                          k_offset=k_off, causal=causal, window=window,
                          bq=4, bkv=bkv, interpret=True)
    got = fops.flash_hop(to_torch(q), to_torch(k), to_torch(v),
                         tuple(map(to_torch, st)), q_offset=q_off,
                         k_offset=k_off, causal=causal, window=window)
    _close(got, want)
    # ... and the reference's jnp oracle on the kernel layout
    g = h // kvh
    q4, k3, v3 = rops._fold_gqa(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    m4, l4, a4 = rops._state_to_kernel(tuple(map(jnp.asarray, st)), b, kvh, g)
    qp = (q_off + jnp.arange(sq, dtype=jnp.int32))[:, None]
    kp = (k_off + jnp.arange(t, dtype=jnp.int32))[:, None]
    klen = jnp.full((b * kvh, 1), 2 ** 30, jnp.int32)
    o = rops._carry_reference(q4, k3, v3, m4, l4, a4, qp, kp, klen,
                              causal=causal, window=window)
    _close(got, rops._state_from_kernel(*o, b, kvh, g))


def test_flash_hop_per_row_klen_decode(ref):
    """Decode regime: Sq=1, causal=False, a per-row key bound (pos+1)."""
    from repro.kernels.flash_attention import ops as rops
    rng = np.random.default_rng(1)
    b, t, h, kvh, hd = 4, 12, 4, 2, 8
    q, k, v = _rand(rng, b, 1, h, hd), _rand(rng, b, t, kvh, hd), \
        _rand(rng, b, t, kvh, hd)
    klen = np.array([3, 7, 12, 1], np.int32)
    st = _state(rng, b, h, 1, hd, True)
    want = rops.flash_hop(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          tuple(map(jnp.asarray, st)), q_offset=0,
                          k_offset=0, k_len=jnp.asarray(klen), causal=False,
                          bkv=4, interpret=True)
    got = fops.flash_hop(to_torch(q), to_torch(k), to_torch(v),
                         tuple(map(to_torch, st)), k_len=torch.tensor(klen),
                         causal=False)
    _close(got, want)


def test_flash_hop_per_row_offsets_and_rows(ref):
    """The port's ring extensions: per-row offsets equal the reference run
    row by row, and ``kv_rows`` equals gathering the K/V rows first."""
    from repro.kernels.flash_attention import ops as rops
    rng = np.random.default_rng(2)
    b, sq, t, h, kvh, hd = 3, 4, 8, 4, 2, 8
    q = _rand(rng, b, sq, h, hd)
    k, v = _rand(rng, 5, t, kvh, hd), _rand(rng, 5, t, kvh, hd)
    rows = np.array([4, 0, 2])
    q_off, k_off = np.array([0, 4, 8]), np.array([8, 0, 4])
    st = _state(rng, b, h, sq, hd, False)
    got = fops.flash_hop(to_torch(q), to_torch(k), to_torch(v),
                         tuple(map(to_torch, st)),
                         q_offset=torch.tensor(q_off),
                         k_offset=torch.tensor(k_off), causal=True,
                         kv_rows=torch.tensor(rows))
    for i in range(b):
        want = rops.flash_hop(
            jnp.asarray(q[i:i + 1]), jnp.asarray(k[rows[i]][None]),
            jnp.asarray(v[rows[i]][None]),
            tuple(jnp.asarray(s[i:i + 1]) for s in st),
            q_offset=int(q_off[i]), k_offset=int(k_off[i]), causal=True,
            interpret=True)
        _close([x[i:i + 1] for x in got], want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_normalized_vs_reference(ref, causal):
    """The kernel's ``normalize`` form from zero state == the reference's
    self-contained flash attention."""
    from repro.kernels.flash_attention import ops as rops
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 8, 4, 8), _rand(rng, 2, 8, 2, 8), \
        _rand(rng, 2, 8, 2, 8)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=4, bkv=4)
    zero = torch.zeros(2, dtype=torch.int32)
    _, _, out = flash_carry(to_torch(q), to_torch(k), to_torch(v),
                            *fops.zero_state(2, 4, 8, 8, "cpu"), zero, zero,
                            zero + 8, causal=causal, normalize=True)
    _close([out.transpose(1, 2)], [want])


@pytest.mark.parametrize("skv,kv_block", [(8, 4), (11, 4)])
def test_blocked_attention_vs_reference(ref, skv, kv_block):
    """The dense path's blocked attention (the flash twin per KV block,
    padded tail masked) == the reference's."""
    from repro.models import attention as rattn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, skv, 4, 8), _rand(rng, 2, skv, 2, 8), \
        _rand(rng, 2, skv, 2, 8)
    want = rattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=3,
                                   kv_block=kv_block)
    got = attn.blocked_attention(to_torch(q), to_torch(k), to_torch(v),
                                 causal=True, window=3, kv_block=kv_block)
    _close([got], [want])


@pytest.mark.parametrize("m,k,n,carry", [
    (16, 32, 24, False), (16, 32, 24, True),
    (37, 20, 11, False), (37, 20, 11, True),      # ragged: no block tiles
])
def test_tile_matmul_twin_vs_reference(ref, m, k, n, carry):
    from repro.kernels.systolic_matmul.ops import tile_matmul as r_tile
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 2, m, k), _rand(rng, k, n)
    acc = _rand(rng, 2, m, n) if carry else None
    want = r_tile(jnp.asarray(x), jnp.asarray(w),
                  None if acc is None else jnp.asarray(acc), interpret=True)
    got = tile_matmul(to_torch(x), to_torch(w),
                      None if acc is None else to_torch(acc))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MATMUL_RTOL, atol=MATMUL_RTOL)


def test_tile_matmul_batched_pes_vs_reference(ref):
    """w [P,K,N]: one product per PE, each equal to the reference's."""
    from repro.kernels.systolic_matmul.ops import tile_matmul as r_tile
    rng = np.random.default_rng(5)
    p, b, s, k, n = 3, 2, 8, 16, 24
    x, w, acc = _rand(rng, p, b, s, k), _rand(rng, p, k, n), \
        _rand(rng, p, b, s, n)
    got = tile_matmul(to_torch(x), to_torch(w), to_torch(acc))
    for i in range(p):
        want = r_tile(jnp.asarray(x[i]), jnp.asarray(w[i]),
                      jnp.asarray(acc[i]), interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=MATMUL_RTOL, atol=MATMUL_RTOL)


def test_tile_matmul_dtype_contract():
    """Output follows the reference: fp32 with an fp32 carry, else the
    promoted input type; a bf16 carry rounds to bf16."""
    x = torch.randn(4, 8, dtype=torch.bfloat16)
    w = torch.randn(8, 6, dtype=torch.bfloat16)
    assert tile_matmul(x, w).dtype == torch.bfloat16
    assert tile_matmul(x, w, torch.zeros(4, 6)).dtype == torch.float32
    assert tile_matmul(x, w, torch.zeros(4, 6, dtype=torch.bfloat16)).dtype \
        == torch.bfloat16


def test_tile_matmul_grad_matches_plain():
    x = torch.randn(3, 5, 8, requires_grad=True)
    w = torch.randn(3, 8, 4, requires_grad=True)
    tile_matmul(x, w).sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    torch.matmul(x, w).sum().backward()
    torch.testing.assert_close(gx, x.grad)
    torch.testing.assert_close(gw, w.grad)
