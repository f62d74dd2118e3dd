"""The port's CUDA kernels against their plain twins, on the card.

CUDA kernels have no CPU mode: every test here needs an NVIDIA GPU and
``nvcc`` and skips elsewhere. The file imports no JAX, so it runs on a
machine with only PyTorch and CUDA::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 results differ from the twin only in the order of fp32
sums (1e-4); bf16 results add one bf16 rounding (2e-2). The conv2d and
FFT-stage kernels round every product and sum as their twins do, so they
are held to 1e-5 (fp32; conv2d, in the twin's order, bit for bit) and one
bf16 rounding (1e-2). The SSD chunk kernel is held to 1e-4 relative to its
largest output, the reference's bound for its Pallas kernel against the
chunked scan; bf16 inputs are widened to fp32 alike in kernel and twin (the
tensor-core body's products of bf16 values are exact, and it splits M and
x * w into two bf16 halves), so the bound holds for them too. The
one-launch FFT equals its twin bit for bit. The flash backward kernel is
held to its closed-form twin at the saved outputs: bf16 gradients within
2^-7 of the largest (its products take bf16 operands), fp32 state
gradients within 1e-5 and the CUDA-core body's fp32 gradients within 1e-4
of max(1, the largest), bit-identical from call to call. The SSD backward
kernel is held to the twin's autograd: bf16 dx, dB and dC within 2^-7 of
the largest, ddt and da (and every fp32 gradient) within 1e-4 of max(1,
the largest), bit-identical from call to call.
"""
from __future__ import annotations

import ctypes

import pytest
import torch

from repro_torch.kernels.causal_conv import kernel as cck
from repro_torch.kernels.conv2d import kernel as ck
from repro_torch.kernels.fft import kernel as ffk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.systolic_matmul import kernel as mk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["prefill", "decode", "window", "normalize",
                                  "strided"])
def test_cuda_flash_carry_vs_twin(cuda, dtype, case):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, kvh, hd = 6, 4, 2, 128
    sq, t = (1, 70) if case == "decode" else (40, 37)
    q = torch.randn(b, sq, h, hd, generator=g, device=cuda).to(dtype)
    # "strided": K/V rows off 16-byte boundaries, so the wrapper copies them
    width = hd + 4 if case == "strided" else hd
    k = torch.randn(b + 2, t, kvh, width, generator=g,
                    device=cuda).to(dtype)[..., :hd]
    v = torch.randn(b + 2, t, kvh, width, generator=g,
                    device=cuda).to(dtype)[..., :hd]
    m = torch.randn(b, h, sq, generator=g, device=cuda)
    m[0] = -1e30                                  # a row still at the sentinel
    l = torch.rand(b, h, sq, generator=g, device=cuda) + 1
    acc = torch.randn(b, h, sq, hd, generator=g, device=cuda)
    rows = torch.randperm(b + 2, generator=g, device=cuda)[:b]
    q_off = torch.randint(0, 64, (b,), generator=g, device=cuda)
    k_off = torch.randint(0, 64, (b,), generator=g, device=cuda)
    klen = torch.randint(0, 128, (b,), generator=g, device=cuda)
    opts = dict(causal=case != "decode", window=5 if case == "window" else 0,
                normalize=case == "normalize")
    args = (q, k, v, m, l, acc, q_off, k_off, klen, rows)
    got = fk.flash_carry_cuda(*args, **opts)
    want = fk.flash_carry_plain(*args, **opts)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("carry", [None, torch.float32, torch.bfloat16])
def test_cuda_tile_matmul_vs_twin(cuda, dtype, carry):
    g = torch.Generator(device=cuda).manual_seed(0)
    p, m, k, n = 3, 77, 130, 45                   # ragged in every dim
    a = torch.randn(p, m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(p, k, n, generator=g, device=cuda).to(dtype)
    c = None if carry is None else \
        torch.randn(p, m, n, generator=g, device=cuda).to(carry)
    out_dtype = torch.promote_types(dtype, carry or dtype)
    got = mk.matmul_cuda(a, b, c, out_dtype)
    want = mk.matmul_plain(a, b, c, out_dtype)
    torch.cuda.synchronize()
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the serving path's ring hops, qwen3-0.6b on 4 PEs at batch 8 (M = 512
# rows per PE): (P, M, K, N)
HOP_SHAPES = {"ffn_ag_hop": (4, 512, 1024, 768),
              "qkv_q_hop": (4, 512, 1024, 512),
              "ffn_rs_hop": (4, 512, 768, 1024)}


def matmul_check(a, b, c, out_dtype, rel):
    """Kernel against twin within ``rel`` of the output's largest value."""
    got = mk.matmul_cuda(a, b, c, out_dtype)
    want = mk.matmul_plain(a, b, c, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    assert got.is_contiguous()
    tol = rel * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("hop", list(HOP_SHAPES))
def test_cuda_tile_matmul_bf16_hop_shapes(cuda, hop, carry):
    """The wgmma body at the main path's shapes: one bf16 rounding (2^-8
    relative) of fp32 sums taken in another order."""
    g = torch.Generator(device=cuda).manual_seed(5)
    p, m, k, n = HOP_SHAPES[hop]
    bf = torch.bfloat16
    a = torch.randn(p, m, k, generator=g, device=cuda).to(bf)
    b = torch.randn(p, k, n, generator=g, device=cuda).to(bf)
    c = torch.randn(p, m, n, generator=g, device=cuda).to(bf) if carry \
        else None
    matmul_check(a, b, c, bf, 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tile_matmul_pads_what_the_body_cannot_take(cuda, dtype):
    """K and N off the 16-byte quantum, operands starting off 16 bytes:
    the wrapper pads or copies them, and the result is the twin's."""
    g = torch.Generator(device=cuda).manual_seed(6)
    p, m, k, n = 2, 77, 45, 130
    flat = torch.randn(p * m * k + 1, generator=g, device=cuda).to(dtype)
    a = flat[1:].view(p, m, k)                    # starts 2 or 4 bytes in
    assert a.data_ptr() % 16
    b = torch.randn(p, k, n, generator=g, device=cuda).to(dtype)
    c = torch.randn(p, m, n, generator=g, device=cuda).to(dtype)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    matmul_check(a, b, c, dtype, rel)
    matmul_check(a, b, None, dtype, rel)


@pytest.mark.cuda
def test_cuda_tile_matmul_fp32_cannon_tile(cuda):
    """The SGEMM body at Cannon's card-scale tile (512^3) with an fp32
    carry: exact fp32 FMAs, so only the order of the sums differs."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a, b, c = (torch.randn(4, 512, 512, generator=g, device=cuda)
               for _ in range(3))
    matmul_check(a, b, c, torch.float32, 1e-5)


def prefill_hop_case(dev, peak, seed=0):
    """qwen3's prefill hop per (row, KV head): G = 2, Sq = 64, T = 64,
    D = 128; PE i's queries against PE i-1's keys, causal, so PE 0's rows
    see a fully masked tile; every third row still at the sentinel. q is
    scaled by ``peak`` (a peaked softmax), V and acc by 16 (|acc| >> 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bp, sq, h, kvh, hd = 8, 64, 4, 2, 128
    bf = torch.bfloat16
    q = (torch.randn(bp, sq, h, hd, generator=g, device=dev) * peak).to(bf)
    k = torch.randn(bp, sq, kvh, hd, generator=g, device=dev).to(bf)
    v = (torch.randn(bp, sq, kvh, hd, generator=g, device=dev) * 16).to(bf)
    m = torch.randn(bp, h, sq, generator=g, device=dev)
    m[::3] = -1e30
    l = torch.rand(bp, h, sq, generator=g, device=dev) + 1
    acc = torch.randn(bp, h, sq, hd, generator=g, device=dev)
    pe = torch.arange(bp, device=dev) % 4
    src = (pe - 1) % 4
    big = torch.full((bp,), 2 ** 30, device=dev)
    return (q, k, v, m, l, acc, pe * sq, src * sq, big, None)


def acc_with_p_in_bf16(q, k, v, m, l, acc, q_off, k_off, klen, kv_row):
    """The carried acc of a causal hop if P went through one bf16 rounding
    before P @ V (what the kernel must not do)."""
    bp, sq, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    gq = h // kvh
    s = torch.einsum("bskgd,btkd->bkgst",
                     q.float().reshape(bp, sq, kvh, gq, d), k.float())
    s = s.reshape(bp, h, sq, t) / d ** 0.5
    mask = fk.key_mask(q_off, k_off, klen, sq, t, causal=True, window=0)
    s = torch.where(mask[:, None], s, torch.full_like(s, fk.NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None]).bfloat16().float()
    pv = torch.einsum("bkgst,btkd->bkgsd", p.reshape(bp, kvh, gq, sq, t),
                      v.float()).reshape(bp, h, sq, d)
    return acc * torch.exp(m - m_new)[..., None] + pv


@pytest.mark.cuda
@pytest.mark.parametrize("peak", [1.0, 8.0])
def test_cuda_flash_carry_prefill_hop_state(cuda, peak):
    """The tensor-core body at qwen3's prefill-hop shape holds the carried
    state within 2e-4 of its largest value, a bound that one bf16 rounding
    of P would break (checked here on the same inputs)."""
    args = prefill_hop_case(cuda, peak)
    got = fk.flash_carry_cuda(*args, causal=True)
    want = fk.flash_carry_plain(*args, causal=True)
    torch.cuda.synchronize()
    tol = 2e-4 * max(1.0, float(want[2].abs().max()))
    rounded = float((acc_with_p_in_bf16(*args) - want[2]).abs().max())
    assert rounded > tol, (rounded, tol)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        err = float((x - y).abs().max())
        assert err <= 2e-4 * max(1.0, float(y.abs().max())), err
    out = fk.flash_carry_cuda(*args, causal=True, normalize=True,
                              out_dtype=torch.bfloat16)
    ref = fk.flash_carry_plain(*args, causal=True, normalize=True,
                               out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out[2].dtype == torch.bfloat16
    torch.testing.assert_close(out[2].float(), ref[2].float(), rtol=2e-2,
                               atol=2e-2 * float(ref[2].float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_carry_decode_hop(cuda, q_dtype):
    """The key-split body at a decode hop: one query per row read against
    a bf16 cache view through ``kv_row``, with per-row key bounds (none,
    some, all of the shard) and rows at the sentinel."""
    g = torch.Generator(device=cuda).manual_seed(8)
    bp, h, kvh, hd, t, n_pe = 8, 16, 8, 128, 256, 4
    kc = torch.randn(bp * n_pe, t, kvh, hd, generator=g,
                     device=cuda).bfloat16()
    vc = torch.randn(bp * n_pe, t, kvh, hd, generator=g,
                     device=cuda).bfloat16()
    q = torch.randn(bp, 1, h, hd, generator=g, device=cuda).to(q_dtype)
    m = torch.randn(bp, h, 1, generator=g, device=cuda)
    m[::2] = -1e30
    l = torch.rand(bp, h, 1, generator=g, device=cuda) + 1
    acc = torch.randn(bp, h, 1, hd, generator=g, device=cuda)
    kv_row = torch.randperm(bp * n_pe, generator=g, device=cuda)[:bp]
    k_off = torch.tensor([0, 256, 0, 512, 256, 0, 768, 0], device=cuda)
    klen = torch.tensor([0, 300, 256, 520, 256, 1, 1024, 97], device=cuda)
    args = (q, kc, vc, m, l, acc, 0 * klen, k_off, klen, kv_row)
    got = fk.flash_carry_cuda(*args, causal=False)
    want = fk.flash_carry_plain(*args, causal=False)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        err = float((x - y).abs().max())
        assert err <= 2e-4 * max(1.0, float(y.abs().max())), err


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_reject_mismatch(cuda):
    from repro_torch.kernels.systolic_matmul.ops import tile_matmul
    a = torch.randn(1, 8, 8, device=cuda)
    before = mk.TILE_MATMUL.launches
    tile_matmul(a, a)
    assert mk.TILE_MATMUL.launches == before + 1
    with pytest.raises(ValueError):
        mk.matmul_cuda(a, a.cpu())


@pytest.mark.cuda
def test_cuda_backward_matches_plain_autograd(cuda):
    """The kernels' autograd.Functions differentiate the plain twins."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.systolic_matmul.ops import tile_matmul
    g = torch.Generator(device=cuda).manual_seed(1)

    def leaf(*shape):
        return torch.randn(*shape, generator=g, device=cuda).requires_grad_()

    q, k, v = leaf(2, 8, 4, 16), leaf(2, 8, 2, 16), leaf(2, 8, 2, 16)
    state = fops.zero_state(2, 4, 8, 16, cuda)
    got = fops.flash_hop(q, k, v, state, causal=True)[2].sum()
    grads = torch.autograd.grad(got, (q, k, v))
    rows = torch.arange(2, device=cuda, dtype=torch.int32)
    want = fk.flash_carry_plain(q, k, v, *state, rows * 0, rows * 0,
                                rows * 0 + 2 ** 30, causal=True)[2].sum()
    for a, b in zip(grads, torch.autograd.grad(want, (q, k, v))):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    x, w, c = leaf(3, 5, 8), leaf(3, 8, 4), leaf(3, 5, 4)
    got = torch.autograd.grad(tile_matmul(x, w, c).square().sum(), (x, w, c))
    want = torch.autograd.grad((c + x @ w).square().sum(), (x, w, c))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,r,w,halos,shift", [
    (4, 3, 300, "both", 0),   # ragged width in bf16, rows under one strip
    (2, 40, 257, "both", 0),  # generic body: one column past a block
    (3, 1, 31, "none", 0),    # narrower than a warp, zero halos
    (1, 64, 64, "none", 0),   # the whole-image form
    (2, 70, 1024, "both", 0),  # 16-byte body, three strips, a short last
    (3, 33, 1030, "both", 0),  # ragged under a vector multiple: generic
    (2, 17, 1032, "both", 0),  # over 1024 by one bf16 vector: 16-byte body
    (2, 17, 1028, "both", 0),  # a vector multiple in fp32 only
    (2, 9, 1024, "top", 0),   # top halo given, bottom zero
    (2, 9, 1024, "bot", 0),   # bottom halo given, top zero
    (2, 3, 1030, "both", "pe"),  # x = buf[1:]: off 16-byte boundaries
    (2, 5, 1024, "both", 2),  # x 2 elements into its storage: generic
])
def test_cuda_conv2d_vs_twin(cuda, dtype, p, r, w, halos, shift):
    """Every body against the twin: fp32 bit for bit, since kernel and twin
    round every product and sum alike in the same order; bf16 within one
    bf16 rounding. ``shift`` moves x in its storage (by one PE block for
    "pe", else by that many elements) so that its data pointer is not
    16-byte aligned."""
    g = torch.Generator(device=cuda).manual_seed(2)
    if shift == "pe":
        x = torch.randn(p + 1, r, w, generator=g, device=cuda).to(dtype)[1:]
    else:
        flat = torch.randn(shift + p * r * w, generator=g,
                           device=cuda).to(dtype)
        x = flat[shift:].view(p, r, w)
    assert x.is_contiguous()
    assert (x.data_ptr() % 16 == 0) == (shift == 0)
    top = bot = None
    if halos in ("both", "top"):
        top = torch.randn(p, 1, w, generator=g, device=cuda).to(dtype)
    if halos in ("both", "bot"):
        bot = torch.randn(p, 1, w, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, 3, generator=g, device=cuda).to(dtype)
    before = ck.CONV2D_3X3.launches
    got = ck.conv_cuda(x, top, bot, k)
    want = ck.conv_plain(x, top, bot, k)
    torch.cuda.synchronize()
    assert got.dtype == dtype and ck.CONV2D_3X3.launches == before + 1
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_fft_stage_vs_twin(cuda, reverse):
    from repro_torch.core.fft import twiddle_table
    g = torch.Generator(device=cuda).manual_seed(3)
    p, b, n = 6, 5, 256
    x = torch.complex(torch.randn(p, b, n, generator=g, device=cuda),
                      torch.randn(p, b, n, generator=g, device=cuda))
    stage = torch.tensor([0, 1, 2, 3, 0, 9], dtype=torch.int32, device=cuda)
    tw = twiddle_table(n, cuda)
    got = ffk.stage_cuda(x, stage, tw, reverse)
    want = ffk.stage_plain(x, stage, tw, reverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:5], want[:5], rtol=1e-5, atol=1e-5)
    assert bool(torch.isnan(got[5]).all())     # no stage 9: poisoned


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(4096, 256), (64, 256), (3, 16),
                                    (5, 1024)])
def test_cuda_fft_full_vs_twin(cuda, rows, n):
    """The one-launch transform equals D stage twins bit for bit."""
    from repro_torch.core.fft import twiddle_table
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.complex(torch.randn(rows, n, generator=g, device=cuda),
                      torch.randn(rows, n, generator=g, device=cuda))
    tw = twiddle_table(n, cuda)
    before = ffk.FFT_STAGE.launches
    got = ffk.fft_full_cuda(x, tw)
    torch.cuda.synchronize()
    assert ffk.FFT_STAGE.launches == before + 1
    assert torch.equal(got, ffk.fft_full_plain(x, tw))


@pytest.mark.cuda
def test_cuda_dsp_paths_count_launches_and_agree(cuda):
    """Each DSP path launches its kernels the expected number of times,
    and every link mode gives the same values as the plain reference."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import fft, halo
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(64, 40, generator=g, device=cuda)
    k = torch.randn(3, 3, generator=g, device=cuda)
    xs = torch.complex(torch.randn(3, 2, 256, generator=g, device=cuda),
                       torch.randn(3, 2, 256, generator=g, device=cuda))
    a = torch.randn(32, 24, generator=g, device=cuda)
    b = torch.randn(24, 16, generator=g, device=cuda)
    outs = {}
    for mode in ("baseline", "sw", "xqueue", "qlr"):
        c0, f0, m0 = (ck.CONV2D_3X3.launches, ffk.FFT_STAGE.launches,
                      mk.TILE_MATMUL.launches)
        y_conv = halo.conv2d_systolic(x, k, 8, mode)
        y_fft = fft.pipelined_fft(xs, 4, mode)
        y_mm = cm.systolic_cannon(a, b, 4, mode)
        torch.cuda.synchronize()
        assert ck.CONV2D_3X3.launches == c0 + 1
        assert ffk.FFT_STAGE.launches == f0 + (1 if mode == "baseline"
                                               else 3 + 3)
        assert mk.TILE_MATMUL.launches == m0 + 4
        outs[mode] = (y_conv, y_fft, y_mm)
    for got in outs.values():
        for y, w in zip(got, outs["baseline"]):
            assert torch.equal(y, w)
    torch.testing.assert_close(outs["qlr"][0], halo.conv2d_ref(x, k),
                               rtol=1e-4, atol=1e-4)
    want = torch.fft.fft(xs, dim=-1)
    assert float((outs["qlr"][1] - want).abs().max()
                 / want.abs().max()) < 1e-3
    torch.testing.assert_close(outs["qlr"][2], a @ b, rtol=1e-4, atol=1e-4)


SSD_CASES = {
    # (batch, heads, groups, chunks, L, P, N, a, dt shift)
    "full_width": (1, 8, 1, 2, 256, 64, 128, None, 0.0),
    "groups2": (2, 4, 2, 3, 64, 64, 128, None, 0.0),
    "ragged": (2, 3, 1, 2, 100, 24, 40, None, 0.0),
    "small": (2, 4, 1, 3, 16, 16, 16, None, 0.0),
    "zamba2": (1, 4, 1, 2, 256, 64, 64, None, 0.0),     # zamba2-1.2b's P, N
    # zamba2-1.2b's prefill of 4 x 2048 tokens: x [256, 8, 256, 64], N = 64
    "zamba2_prefill": (4, 64, 1, 8, 256, 64, 64, -1.0, 0.0),
    # cum reaches about -1300: exp(cum) underflows, and above the diagonal
    # exp(cum[t] - cum[s]) overflows to inf
    "overflow": (1, 2, 1, 2, 256, 64, 128, -4.0, 1.0),
}


def ssd_inputs(dev, dtype, bsz, h, g, nc, l, p, n, a_val, dt_shift, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = rnd(bsz * h, nc, l, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(bsz * h, nc, l, 1) + dt_shift)
    a_h = torch.full((h,), a_val, device=dev) if a_val is not None \
        else -torch.exp(rnd(h) * 0.3)
    a = a_h.repeat(bsz).reshape(bsz * h, 1, 1, 1)
    b = (rnd(bsz * g, nc, l, n) * 0.3).to(dtype)
    c = (rnd(bsz * g, nc, l, n) * 0.3).to(dtype)
    return x, dt, a, b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_cuda_ssd_chunks_vs_twin(cuda, dtype, case):
    bsz, h, g, nc, l, p, n, a_val, shift = SSD_CASES[case]
    args = ssd_inputs(cuda, dtype, bsz, h, g, nc, l, p, n, a_val, shift)
    got = sk.ssd_chunks_cuda(*args, nheads=h, ngroups=g)
    want = sk.ssd_chunks_plain(*args, nheads=h, ngroups=g)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        tol = 1e-4 * max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x, y, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("l,p,n", [(64, 24, 40), (100, 50, 72), (77, 13, 37),
                                   (48, 64, 100), (256, 8, 128)])
def test_cuda_ssd_chunks_bf16_ragged_tiles(cuda, l, p, n):
    """The tensor-core body zero-pads P and N to multiples of 16 (and L to
    the 64-row tile); an odd P or N also takes its element-wise loads."""
    args = ssd_inputs(cuda, torch.bfloat16, 2, 2, 1, 2, l, p, n, None, 0.0,
                      seed=l + p + n)
    got = sk.ssd_chunks_cuda(*args, nheads=2, ngroups=1)
    want = sk.ssd_chunks_plain(*args, nheads=2, ngroups=1)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        tol = 1e-4 * max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x, y, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, a, b, c = ssd_inputs(cuda, torch.float32, 1, 2, 1, 1, 16, 16,
                                16, None, 0.0)
    with pytest.raises(ValueError):
        sk.ssd_chunks_cuda(x, dt, a, b.cpu(), c, nheads=2, ngroups=1)
    with pytest.raises(TypeError):
        sk.ssd_chunks_cuda(x, dt, a, b.bfloat16(), c, nheads=2, ngroups=1)
    wide = torch.zeros(2, 1, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="headdim"):
        sk.ssd_chunks_cuda(wide, dt, a, b, c, nheads=2, ngroups=1)


@pytest.mark.cuda
def test_cuda_mamba_prefill_launches_ssd_once_per_layer(cuda):
    """SMOKE mamba2 prefill on the card: one SSD launch per layer, and the
    logits match the same parameters' prefill on the CPU (the twin)."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = replace(get_smoke_config("mamba2-1.3b"), dtype="float32",
                  param_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    before = sk.SSD_CHUNKS.launches
    got = model.prefill(params, tokens)
    torch.cuda.synchronize()
    assert sk.SSD_CHUNKS.launches == before + cfg.num_layers
    from repro_torch.serve.sharded_cache import _to_device
    want = model.prefill(_to_device(params, "cpu"), tokens.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


SSD_GRADS = ("dx", "ddt", "da", "db", "dc")
# (batch, heads, groups, L, P, N, slices): heads a group that the backward
# plan splits into uneven slices (6 into 4, 5 into 3) at a chunk count
# chosen for the card's resident blocks (``ssd_slice_case``)
SSD_SLICE_CASES = {"slices_6h_1g": (1, 6, 1, 64, 64, 64, 4),
                   "slices_5h_2g": (1, 10, 2, 64, 64, 64, 3)}


def ssd_slice_case(dev, dtype, case):
    """An ``SSD_CASES``-style tuple for a ``SSD_SLICE_CASES`` case: the
    chunks that make the plan pick its slices on this card, which leave
    the group's heads in slices of unequal size."""
    bsz, h, g, l, p, n, want = SSD_SLICE_CASES[case]
    tc = dtype == torch.bfloat16
    probe = torch.empty(1, 1, l, p, dtype=dtype, device=dev)
    resident = sk.backward_resident(probe, probe.new_empty(1, 1, l, n))
    tiles = -(-l // sk.BWD_TILE) if tc else 1
    nc = -(-2 * resident // (want * bsz * g * tiles))
    slices = sk.backward_plan(bsz * g, nc, l, h // g, resident,
                              tensor_cores=tc)
    sizes = {end - first for first, end in sk.backward_heads(h // g, slices)}
    assert slices == want and len(sizes) > 1, (resident, nc, slices)
    return bsz, h, g, nc, l, p, n, None, 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["zamba2_prefill", "full_width", "groups2",
                                  "ragged", "small", "overflow",
                                  *SSD_SLICE_CASES])
def test_cuda_ssd_chunks_grads_vs_twin(cuda, dtype, case):
    """``_SSDChunks`` on the card: one forward and one backward kernel
    launch, against the twin's autograd at the same inputs, taken in
    float64 (``cum`` the same fp32 values). bf16: dx, dB and dC within 2^-7
    of the largest (the products take bf16 operands), ddt and da within
    1e-4 of max(1, the largest); fp32: every gradient within 1e-4 of
    max(1, the largest). Finite where the decay above the diagonal
    overflows, and bit-identical from call to call. The oracle is float64
    because da is ill-conditioned: an error in dcum[t] reaches it times
    sum_{s<=t} dt[s], and at an overflow case (a = -4, cum near -1300)
    the fp32 twin's own da misses 1e-4 of its largest against the float64
    value (``tests/test_torch_ssd_backward.py``). The ``SSD_SLICE_CASES``
    run the plan's uneven head slices."""
    bsz, h, g, nc, l, p, n, a_val, shift = SSD_CASES[case] \
        if case in SSD_CASES else ssd_slice_case(cuda, dtype, case)
    args = ssd_inputs(cuda, dtype, bsz, h, g, nc, l, p, n, a_val, shift,
                      seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    diff = [t.detach().requires_grad_(True) for t in args]
    bh = bsz * h
    ups = [torch.randn(shape, generator=gen, device=cuda) for shape in
           ((bh, nc, l, p), (bh, nc, p, n), (bh, nc, l, 1))]
    before = sk.SSD_CHUNKS.launches, sk.SSD_CHUNKS_BWD.launches
    got = torch.autograd.grad(sk.ssd_chunks(*diff, nheads=h, ngroups=g),
                              diff, ups)
    assert (sk.SSD_CHUNKS.launches - before[0],
            sk.SSD_CHUNKS_BWD.launches - before[1]) == (1, 1)
    again = torch.autograd.grad(sk.ssd_chunks(*diff, nheads=h, ngroups=g),
                                diff, ups)
    wide = [t.detach().double().requires_grad_(True) for t in args]
    want = torch.autograd.grad(
        sk.ssd_chunks_plain(*wide, nheads=h, ngroups=g), wide,
        [u.double() for u in ups])
    torch.cuda.synchronize()
    for name, x, y, z, leaf in zip(SSD_GRADS, got, want, again, diff):
        assert x.shape == leaf.shape and x.dtype == leaf.dtype, name
        assert bool(torch.isfinite(x).all()), name
        assert torch.equal(x, z), name
        scale = float(y.abs().max())
        tol = 2.0 ** -7 * scale if dtype == torch.bfloat16 \
            and name in ("dx", "db", "dc") else 1e-4 * max(1.0, scale)
        torch.testing.assert_close(x.double(), y, rtol=0, atol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_cuda_ssd_chunks_backward_refuses_wide_state(cuda):
    """N > 128 is not taken by either kernel: the forward and the backward
    wrapper raise, and nothing falls back to a twin."""
    args = ssd_inputs(cuda, torch.bfloat16, 1, 2, 1, 1, 16, 16, 136, None,
                      0.0)
    diff = [t.detach().requires_grad_(True) for t in args]
    with pytest.raises(ValueError, match="state"):
        sk.ssd_chunks(*diff, nheads=2, ngroups=1)
    ups = [torch.zeros(2, 1, 16, 16, device=cuda),
           torch.zeros(2, 1, 16, 136, device=cuda), None]
    before = sk.SSD_CHUNKS_BWD.launches
    with pytest.raises(ValueError, match="state"):
        sk.ssd_chunks_backward_cuda(*args, *ups, nheads=2, ngroups=1)
    assert sk.SSD_CHUNKS_BWD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba2_forward_grads_vs_cpu(cuda, dtype):
    """Gradients of a Mamba2 layer (SMOKE zamba2 widths, chunk 8, two
    chunks) on the card (the SSD and causal conv kernels forward and
    backward, one launch each) against the same call on the CPU (the twins
    throughout), at ``tests/test_torch_ssm.py``'s bounds: fp32 1e-4, bf16
    2e-2."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    from repro_torch.serve.sharded_cache import _to_device
    cfg = replace(get_smoke_config("zamba2-1.2b"), dtype=dtype,
                  param_dtype=dtype)
    params = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    params["A_log"] = torch.randn(params["A_log"].shape,
                                  generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(2)).to(
        params["w_in"].dtype)
    up = torch.randn(2, 16, cfg.d_model,
                     generator=torch.Generator().manual_seed(3))

    def grads(p, xx):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xx = xx.detach().requires_grad_(True)
        y = ssm.mamba2_forward(leaves, xx, cfg)
        got = torch.autograd.grad(y, [xx, *leaves.values()],
                                  up.to(y.device, y.dtype))
        return [g.cpu().float() for g in got]

    kernels = (sk.SSD_CHUNKS, sk.SSD_CHUNKS_BWD, cck.CAUSAL_CONV,
               cck.CAUSAL_CONV_BWD)
    before = [k.launches for k in kernels]
    got = grads(_to_device(params, cuda), x.to(cuda))
    assert [k.launches for k in kernels] == [n + 1 for n in before]
    want = grads(params, x)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, b in zip(["x", *params], got, want):
        assert bool(torch.isfinite(a).all()), name
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=tol * scale,
                                   msg=name)


@pytest.mark.cuda
def test_cuda_zamba_ring_loss_and_grads_vs_cpu(cuda):
    """SMOKE zamba2 in fp32 on a ring of 2 in qlr, remat "full", on the
    card (all three kernels, forward and recompute) against the same loss
    and gradients on the CPU: loss 1e-4, gradients 1e-3."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve.sharded_cache import _to_device
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    cfg = replace(get_smoke_config("zamba2-1.2b"), dtype="float32",
                  param_dtype="float32", systolic_mode="qlr")
    model = build_model(cfg, n_pe=2)
    params = model.init(0, device="cpu")
    raw = torch.randint(0, cfg.vocab_size, (2, 17),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": raw[:, :-1], "targets": raw[:, 1:]}
    counts = lambda: (sk.SSD_CHUNKS.launches,     # noqa: E731
                      sk.SSD_CHUNKS_BWD.launches, mk.TILE_MATMUL.launches,
                      fk.FLASH_CARRY.launches)
    before = counts()
    loss, _, grads = step_lib.value_and_grad(
        model, _to_device(params, cuda),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(counts(), before)]
    assert all(launched), launched
    want_loss, _, want = step_lib.value_and_grad(model, params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    for a, b in zip(opt.tree_leaves(grads), opt.tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# training: the autograd.Functions at the training hops, and a ring step
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ffn_ag", "ffn_rs_carry", "expanded"])
def test_cuda_tile_matmul_grads_at_training_hops(cuda, case):
    """``_TileMatmul``'s gradients at qwen3-0.6b's training hops (B=8,
    S=1024 on a ring of 4): bf16 products (the reference's plain form)
    against the fp32 twin's autograd, within one bf16 rounding of the
    largest gradient; a weight expanded over the PE dimension gets its
    gradient summed back."""
    from repro_torch.kernels.systolic_matmul import ops as mm_ops
    g = torch.Generator(device=cuda).manual_seed(3)
    bf = torch.bfloat16

    def rnd(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) * 0.1).to(bf)

    p, m, d, f = 4, 2048, 1024, 768
    c = None
    if case == "ffn_rs_carry":
        a, w, c = rnd(p, m, f), rnd(p, f, d), rnd(p, m, d)
    elif case == "expanded":                 # one [D, F] weight for all PEs
        a, w = rnd(p, m, d), rnd(d, f)
    else:
        a, w = rnd(p, m, d), rnd(p, d, f)
    leaves = [x.requires_grad_(True) for x in (a, w, c) if x is not None]

    def run(fn):
        b = w[None].expand(p, *w.shape) if case == "expanded" else w
        out = fn(a, b, c, bf)
        up = torch.randn(out.shape, generator=torch.Generator(
            device=cuda).manual_seed(4), device=cuda).to(bf)
        return out, torch.autograd.grad(out, leaves, up)

    before = mk.TILE_MATMUL.launches
    out, got = run(mm_ops._TileMatmul.apply)
    assert mk.TILE_MATMUL.launches == before + 1
    want_out, want = run(mk.matmul_plain)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(), rtol=2e-2,
                               atol=2e-2)
    for x, y, leaf in zip(got, want, leaves):
        assert x.shape == leaf.shape and x.dtype == leaf.dtype
        tol = 2 ** -7 * float(y.float().abs().max())
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol)


# (n PEs, rows of PE x batch, queries and keys a hop, heads, KV heads,
# head_dim, window, dtype of q / of K/V): hop 1 of each family's training
# step on its ring (qwen3-0.6b 8 x 1024 on 4 PEs, zamba2-1.2b 4 x 2048 on
# 4, internvl2-1b 4 x 2048 on 2, mixtral-8x22b 1 x 2048 on 4 under a
# window cut to run through the block), and the CUDA-core body's inputs:
# fp32 at qwen3's parity shape (2 x 512 on 4), bf16 at head_dim 16 (the
# SMOKE models' width), one query per row (fp32 q against a bf16 cache)
BWD_HOPS = {
    "qwen3": (4, 32, 256, 16, 8, 128, 0, "bf16", "bf16"),
    "zamba2": (4, 16, 512, 32, 32, 64, 0, "bf16", "bf16"),
    "internvl2": (2, 8, 1024, 14, 2, 64, 0, "bf16", "bf16"),
    "mixtral_window": (4, 4, 512, 48, 8, 128, 600, "bf16", "bf16"),
    "fp32": (4, 8, 128, 16, 8, 128, 0, "fp32", "fp32"),
    "bf16_hd16": (4, 8, 48, 4, 2, 16, 0, "bf16", "bf16"),
    "sq1": (4, 8, 1, 16, 8, 128, 0, "fp32", "bf16"),
}


# hops whose pass B splits each key tile's items over several blocks
# (``backward_split`` > 1: fp32 partials summed in share order): (hop as
# above, query rows a K/V row, the causal diagonal): internvl2's GQA-7 on 2
# rows (64 pass B blocks); 8 query rows over 2 K/V rows at qwen3's widths;
# 200 keys, not a multiple of 64; hop 0's diagonal with every row
# resolved, so that at the last key tile the first shares hold only dead
# (skipped) tiles and their partials must be zero
BWD_SPLIT = {
    "split_gqa7": ((2, 2, 1024, 14, 2, 64, 0, "bf16", "bf16"), 1, False),
    "split_kv_row_shared": ((4, 8, 256, 16, 8, 128, 0, "bf16", "bf16"), 4,
                            False),
    "split_ragged_t": ((2, 2, 200, 14, 2, 64, 0, "bf16", "bf16"), 1, False),
    "split_dead_shares": ((2, 2, 512, 14, 2, 64, 0, "bf16", "bf16"), 1,
                          True),
}


def _bwd_hop(cuda, case):
    """(q, k, v, m, l, acc), (q_off, k_off, klen, kv_row) and the options
    of one backward case. "kv_row" is qwen3's hop read through ``kv_row``
    with every K/V row shared by two query rows (``baseline`` mode's
    repeat), in a shuffled order; ``BWD_SPLIT``'s are split hops."""
    g = torch.Generator(device=cuda).manual_seed(5)
    name = "qwen3" if case == "kv_row" else case
    share, diag = (2, False) if case == "kv_row" else (1, False)
    if case in BWD_SPLIT:
        hop, share, diag = BWD_SPLIT[case]
    else:
        hop = BWD_HOPS[name]
    n, rows, s_l, h, kvh, hd, window, qdt, kvdt = hop
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    pe = torch.arange(n, device=cuda).repeat_interleave(rows // n)
    src = pe if diag else (pe - 1) % n
    t = 256 if name == "sq1" else s_l
    bk = rows // share
    q = torch.randn(rows, s_l, h, hd, generator=g, device=cuda).to(dt[qdt])
    k = torch.randn(bk, t, kvh, hd, generator=g, device=cuda).to(dt[kvdt])
    v = torch.randn(bk, t, kvh, hd, generator=g, device=cuda).to(dt[kvdt])
    m = torch.randn(rows, h, s_l, generator=g, device=cuda)
    if not diag:
        m[::3] = -1e30                  # rows still at the sentinel
    l = torch.rand(rows, h, s_l, generator=g, device=cuda) + 1
    acc = torch.randn(rows, h, s_l, hd, generator=g, device=cuda)
    kv_row = None
    if share > 1:
        kv_row = torch.arange(bk, device=cuda).repeat_interleave(share)[
            torch.randperm(rows, generator=g, device=cuda)]
    if name == "sq1":                   # a decode-shaped row: pos + 1 keys
        ints = (0 * pe, src * t,
                src * t + torch.randint(1, t, (rows,), generator=g,
                                        device=cuda), kv_row)
        causal = False
    else:
        ints = (pe * s_l, src * s_l,
                torch.full((rows,), 2 ** 30, device=cuda), kv_row)
        causal = True
    return (q, k, v, m, l, acc), ints, dict(causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*BWD_HOPS, "kv_row", *BWD_SPLIT])
def test_cuda_flash_carry_grads_at_training_hop(cuda, case):
    """``_FlashCarry``'s backward is the backward kernel (one launch of
    ``flash_carry_bwd``), bit-identical from call to call, and within the
    stated bounds of the twin's closed-form gradient at the saved outputs:
    bf16 gradients (dq, dk, dv of bf16 operands) within 2^-7 of the
    largest, the bound of ``test_cuda_mamba2_forward_grads_vs_cpu`` (the
    tensor-core body takes its products in bf16 with fp32 sums, as
    FlashAttention-2 does); the fp32 state gradients within 1e-5 of
    max(1, the largest); the CUDA-core body's fp32 gradients within 1e-4
    (fp32 sums in another order, the matmul's relative bound of
    ``tests/test_kernels.py``). ``BWD_SPLIT``'s hops split pass B."""
    ins, ints, opts = _bwd_hop(cuda, case)
    if case in BWD_SPLIT:
        assert fk.backward_split(ins[0], ins[1]) > 1
    g = torch.Generator(device=cuda).manual_seed(6)
    diff = [x.clone().requires_grad_(True) for x in ins]
    outs = fk._FlashCarry.apply(*diff, *ints, opts["causal"],
                                opts["window"], False, None)
    ups = [torch.randn(x.shape, generator=g, device=cuda) for x in outs]
    before = fk.FLASH_CARRY_BWD.launches
    got = torch.autograd.grad(outs, diff, ups, retain_graph=True)
    assert fk.FLASH_CARRY_BWD.launches == before + 1
    again = torch.autograd.grad(outs, diff, ups)
    want = fk.flash_carry_backward_plain(
        *ins, *ints, *(o.detach() for o in outs), *ups, **opts)
    torch.cuda.synchronize()
    for i, (x, y, z, leaf) in enumerate(zip(got, want, again, diff)):
        assert x.shape == leaf.shape and x.dtype == leaf.dtype
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, z), f"gradient {i} differs between calls"
        big = float(y.float().abs().max())
        if x.dtype == torch.bfloat16:
            tol = 2 ** -7 * big
        else:
            tol = (1e-5 if i >= 3 else 1e-4) * max(1.0, big)
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_train_step_ring_vs_dense(cuda):
    """One fp32 train step of SMOKE qwen3-0.6b on a ring of 2 in qlr (the
    kernels, forward and remat recompute) against the dense path (no
    kernel): loss 1e-4, grad norm 1e-3 relative, parameters within
    ``2 * lr`` (AdamW's first update is about ``sign(g)``)."""
    from dataclasses import replace
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    cfg = replace(get_smoke_config("qwen3-0.6b"), dtype="float32",
                  param_dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                       schedule="constant")
    state = step_lib.init_state(cfg, tcfg, 0, cuda)
    raw = SyntheticLM(cfg.vocab_size, seed=0).batch(0, 4, 32)
    batch = {"tokens": torch.as_tensor(raw[:, :-1], device=cuda),
             "targets": torch.as_tensor(raw[:, 1:], device=cuda)}
    counts = lambda: (fk.FLASH_CARRY.launches,   # noqa: E731
                      mk.TILE_MATMUL.launches, fk.FLASH_CARRY_BWD.launches)
    before = counts()
    dense, dm = step_lib.make_train_step(cfg, tcfg, 0)(state, batch)
    assert counts() == before
    # the step updates the moments in place: the ring starts afresh
    state = step_lib.init_state(cfg, tcfg, 0, cuda)
    ring, rm = step_lib.make_train_step(
        replace(cfg, systolic_mode="qlr"), tcfg, 2)(state, batch)
    torch.cuda.synchronize()
    # per layer: 2 flash hops and 12 tile hops, run again by the remat,
    # and the backward kernel once per flash hop
    assert tuple(a - b for a, b in zip(counts(), before)) == \
        (2 * 2 * cfg.num_layers, 2 * 12 * cfg.num_layers,
         2 * cfg.num_layers)
    assert abs(float(rm["loss"]) - float(dm["loss"])) <= 1e-4
    assert float(rm["grad_norm"]) == pytest.approx(float(dm["grad_norm"]),
                                                   rel=1e-3)
    for x, y in zip(opt.tree_leaves(ring["params"]),
                    opt.tree_leaves(dense["params"])):
        torch.testing.assert_close(x, y, rtol=0, atol=2 * 1e-3)


# ---------------------------------------------------------------------------
# serving observers: checked links, telemetry, the probe
# ---------------------------------------------------------------------------


def _smoke_ring_backend(cuda, **kw):
    from repro_torch.configs import ServeConfig, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve.sharded_cache import RingShardedBackend
    cfg = get_smoke_config("qwen3-0.6b")
    params = build_model(cfg).init(0, device=cuda)
    scfg = ServeConfig(max_batch=4, max_seq_len=64, prefill_chunk=16)
    return RingShardedBackend(cfg, scfg, params, 4, "qlr", device=cuda, **kw)


@pytest.mark.cuda
def test_cuda_checked_telemetry_serving_launches_as_plain(cuda):
    """Checked links, the probe and telemetry launch no kernel of their
    own and change no value: per prefill and per decode step both kernels
    launch exactly as in plain serving, with bit-identical logits."""
    import numpy as np
    runs = []
    for observed in (False, True):
        be = _smoke_ring_backend(cuda, checked=observed, telemetry=observed)
        launches, logits = [], []
        for call in ("prefill", "decode", "decode"):
            before = (fk.FLASH_CARRY.launches, mk.TILE_MATMUL.launches)
            if call == "prefill":
                be.prefill(1, np.arange(1, 12, dtype=np.int32))
            else:
                logits.append(be.step(np.full((4, 1), 3, np.int32),
                                      np.ones(4, bool)).clone())
            torch.cuda.synchronize()
            launches.append((fk.FLASH_CARRY.launches - before[0],
                             mk.TILE_MATMUL.launches - before[1]))
        runs.append((launches, logits))
        if observed:
            assert be.link_health() == {"tag_errors": 0, "csum_errors": 0}
            assert be.link_stats()["pushes"] > 0
    (plain, plain_logits), (seen, seen_logits) = runs
    assert plain == seen and plain[0][0] > 0 and plain[0][1] > 0
    assert all(f > 0 for f, _ in plain)
    for a, b in zip(plain_logits, seen_logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_corrupt_fault_trips_the_probe_at_its_site(cuda):
    """A corrupt fault at (hop 1, PE 2) trips the checked stream on the
    card at that (PE, hop) only, in the checksum column, and the backend's
    probe reports one checksum error for the step."""
    import numpy as np
    from repro_torch.core import faults, queues
    from repro_torch.core import topology as tp
    payload = torch.arange(16, dtype=torch.float32, device=cuda) \
        .reshape(4, 4) + 1.0
    spec = faults.FaultSpec("corrupt", hop=1, device=2)
    for mode in queues.MODES:
        with faults.inject(spec):
            _, _, health = queues.stream(
                tp.ring("model", 4), payload, 4,
                lambda s, b, t: s + b.sum(dim=1),
                torch.zeros(4, device=cuda), mode, checked=True)
        want = torch.zeros(4, 4, 2, dtype=torch.int32, device=cuda)
        want[2, 1, 1] = 1
        assert torch.equal(health, want), mode
    be = _smoke_ring_backend(cuda, checked=True)
    with faults.inject(spec):
        be.step(np.ones((4, 1), np.int32), np.ones(4, bool))
    assert be.link_health() == {"tag_errors": 0, "csum_errors": 1}
    be.step(np.ones((4, 1), np.int32), np.ones(4, bool))
    assert be.link_health() == {"tag_errors": 0, "csum_errors": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [0, 2, 3])
def test_cuda_flash_carry_windowed_gqa6_hop(cuda, hop):
    """mixtral's ring hop at half its length: 48 heads over 8 KV heads (a
    GQA group of 6), causal, 1024 queries and keys a PE on a ring of 4,
    the window twice the block (as 4096 is at 2 x 8192 tokens). At hop 2
    the window boundary runs through PE 3's tile; at hop 3 no PE sees a
    key. The state within 2e-4 of its scale, as phase 2 of chip_smoke.py
    holds it."""
    g = torch.Generator(device=cuda).manual_seed(hop)
    n, b, s_l, h, kvh, hd = 4, 2, 1024, 48, 8, 128
    window = 2 * s_l
    pe = torch.arange(n, device=cuda).repeat_interleave(b)
    bf = torch.bfloat16
    q = torch.randn(n * b, s_l, h, hd, generator=g, device=cuda).to(bf)
    k = torch.randn(n * b, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    v = torch.randn(n * b, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    m = torch.randn(n * b, h, s_l, generator=g, device=cuda)
    m[::3] = -1e30
    l = torch.rand(n * b, h, s_l, generator=g, device=cuda) + 1
    acc = torch.randn(n * b, h, s_l, hd, generator=g, device=cuda)
    big = torch.full((n * b,), 2 ** 30, device=cuda)
    args = (q, k, v, m, l, acc, pe * s_l, (pe - hop) % n * s_l, big, None)
    opts = dict(causal=True, window=window, normalize=False)
    got = fk.flash_carry_cuda(*args, **opts)
    want = fk.flash_carry_plain(*args, **opts)
    torch.cuda.synchronize()
    scale = max(1.0, float(want[2].abs().max()))
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 2e-4 * scale
    mask = fk.key_mask(pe * s_l, (pe - hop) % n * s_l, big, s_l, s_l,
                       causal=True, window=window)
    if hop == 2:
        assert 0 < int(mask[-1].sum()) < s_l * s_l
    if hop == 3:
        assert not bool(mask.any())


@pytest.mark.cuda
@pytest.mark.parametrize("proj", ["gate_up", "down"])
def test_cuda_tile_matmul_expert_ffn_shape(cuda, proj):
    """The expert FFN's launch over all 8 experts at mixtral's widths, M
    reduced to 640 capacity slots: one bf16 rounding of the twin."""
    g = torch.Generator(device=cuda).manual_seed(0)
    e, m, d, f = 8, 640, 6144, 16384
    k, n = (d, f) if proj == "gate_up" else (f, d)
    a = torch.randn(e, m, k, generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn(e, k, n, generator=g, device=cuda) / k ** 0.5) \
        .to(torch.bfloat16)
    before = mk.TILE_MATMUL.launches
    got = mk.matmul_cuda(a, b)
    assert mk.TILE_MATMUL.launches == before + 1
    want = mk.matmul_plain(a, b)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= \
        2 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ring", "torus2d", "cannon_grid"])
def test_cuda_ring_moe_smoke_modes_bit_identical(cuda, name):
    """``ring_moe`` at mixtral SMOKE's widths (8 experts here, so 2 a PE
    on a ring of 4) through the tile-matmul kernel: 3 launches a call in
    every mode, the ring modes bit for bit, all within 1e-4 of the dense
    dispatch (fp32)."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import ring_moe
    from repro_torch.core import topology as tp
    from repro_torch.models import moe
    cfg = replace(get_smoke_config("mixtral-8x22b"), num_experts=8,
                  dtype="float32", param_dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(0)
    params = moe.init_moe(g, cfg)
    x = torch.randn(2, 32, cfg.d_model, generator=g, device=cuda)
    want, _ = moe.apply_moe(params, x, cfg)
    w, idx, _ = moe._topk_routing(x @ params["router"], cfg)
    pos = moe._positions_in_expert(idx, cfg.num_experts)
    cap = moe.expert_capacity(cfg, 32)
    topo = tp.resolve(name, "model", 4)
    ys = {}
    for mode in ring_moe.MODES:
        before = mk.TILE_MATMUL.launches
        ys[mode] = ring_moe.systolic_ring_moe(
            x, idx, pos, w, params["w_gate"], params["w_up"],
            params["w_down"], cap, 4, mode, topo=topo)
        assert mk.TILE_MATMUL.launches == before + 3
        torch.testing.assert_close(ys[mode], want, rtol=1e-4, atol=1e-4)
    assert torch.equal(ys["sw"], ys["qlr"])
    assert torch.equal(ys["xqueue"], ys["qlr"])


# ---------------------------------------------------------------------------
# the VLM, MLA and Whisper families on the card
# ---------------------------------------------------------------------------


# head_dim-64 hops: (ring size, batch, queries a PE, heads, KV heads, hop,
# window, state): "carried" every third row at the sentinel, "real" every
# row holding a real running max, "fresh" zero state normalized
HD64_HOPS = {
    "internvl2_gqa7": (2, 4, 256, 14, 2, 1, 0, "carried"),
    "whisper_mha6": (2, 4, 256, 6, 6, 1, 0, "carried"),
    "zamba2_mha32": (4, 2, 512, 32, 32, 1, 0, "carried"),
    "windowed": (2, 4, 256, 14, 2, 0, 100, "carried"),
    "normalized": (2, 2, 224, 14, 2, 0, 0, "fresh"),
    "resolved": (2, 4, 224, 6, 6, 1, 0, "real"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(HD64_HOPS))
def test_cuda_flash_carry_head_dim64_hops(cuda, shape):
    """Ring-attention prefill hops at head_dim 64 on the tensor-core body
    (bf16, 64 query rows a block), sequence cut to 224-512 a PE:
    internvl2-1b's 14 heads over 2 KV heads (a GQA group of 7),
    whisper-tiny's decoder (6 heads, MHA) and zamba2-1.2b's shared
    attention (32 heads, MHA, ring of 4), all at hop 1; the causal
    diagonal hop under a window of 100 that cuts K/V tiles (tiles behind
    it skipped, others masked or live); the normalized form from zero
    state at 224 queries (the last K/V tile half full, row blocks across
    GQA groups), also within 2e-2 of SDPA; and a hop where every row holds
    a real max, so PE 0's tiles (all keys ahead of its queries) are
    skipped and its state comes back bit for bit. The state within 2e-4 of
    its scale, as phase 2 of chip_smoke.py holds it; the normalized output
    within 2e-2."""
    import torch.nn.functional as F
    n, b, s_l, h, kvh, hop, window, state = HD64_HOPS[shape]
    g = torch.Generator(device=cuda).manual_seed(3)
    hd = 64
    pe = torch.arange(n, device=cuda).repeat_interleave(b)
    bf = torch.bfloat16
    q = torch.randn(n * b, s_l, h, hd, generator=g, device=cuda).to(bf)
    k = torch.randn(n * b, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    v = torch.randn(n * b, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    if state == "fresh":
        m = torch.full((n * b, h, s_l), -1e30, device=cuda)
        l = torch.zeros(n * b, h, s_l, device=cuda)
        acc = torch.zeros(n * b, h, s_l, hd, device=cuda)
    else:
        m = torch.randn(n * b, h, s_l, generator=g, device=cuda)
        if state == "carried":
            m[::3] = -1e30
        l = torch.rand(n * b, h, s_l, generator=g, device=cuda) + 1
        acc = torch.randn(n * b, h, s_l, hd, generator=g, device=cuda)
    big = torch.full((n * b,), 2 ** 30, device=cuda)
    args = (q, k, v, m, l, acc, pe * s_l, (pe - hop) % n * s_l, big, None)
    opts = dict(causal=True, window=window, normalize=state == "fresh",
                out_dtype=bf if state == "fresh" else None)
    before = fk.FLASH_CARRY.launches
    got = fk.flash_carry_cuda(*args, **opts)
    assert fk.FLASH_CARRY.launches == before + 1
    want = fk.flash_carry_plain(*args, **opts)
    torch.cuda.synchronize()
    scale = max(1.0, float(want[2].float().abs().max()))
    tol = 2e-2 if state == "fresh" else 2e-4
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert float((x.float() - y.float()).abs().max()) <= tol * scale
    if state == "fresh":
        assert got[2].dtype == bf
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt, vt = (x.repeat_interleave(h // kvh, 1) for x in (kt, vt))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        assert float((sdpa.float() - got[2].float()).abs().max()) <= 2e-2
    if state == "real":
        first = pe == 0
        for x, y in zip(got, (m, l, acc)):
            assert torch.equal(x[first], y[first])


def _move(v, dev):
    """Tensors, and dicts, lists and tuples of them, onto ``dev``."""
    if isinstance(v, dict):
        return {k: _move(x, dev) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_move(x, dev) for x in v)
    return v.to(dev)


def _family_vs_cpu(cuda, arch, n_pe, batch_fn, expect):
    """SMOKE ``arch`` in fp32 on a ring of ``n_pe`` in qlr: prefill logits
    and the loss and gradients on the card (its kernels launched as
    ``expect`` reckons them) against the same on the CPU (logits and loss
    1e-4, gradients 1e-3). ``batch_fn`` gives ``prefill``'s arguments
    after the parameters and the training batch."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    cfg = replace(get_smoke_config(arch), dtype="float32",
                  param_dtype="float32", systolic_mode="qlr")
    model = build_model(cfg, n_pe=n_pe)
    params = model.init(0, device="cpu")
    prefill_args, batch = batch_fn(cfg, torch.Generator().manual_seed(1))
    counts = lambda: {"tile_matmul": mk.TILE_MATMUL.launches,   # noqa: E731
                      "flash_carry": fk.FLASH_CARRY.launches}
    before = counts()
    dev_params = _move(params, cuda)
    with torch.no_grad():
        got = model.prefill(dev_params, *_move(prefill_args, cuda))
    loss, _, grads = step_lib.value_and_grad(model, dev_params,
                                             _move(batch, cuda))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    assert launched == expect(cfg), (launched, expect(cfg))
    with torch.no_grad():
        want = model.prefill(params, *prefill_args)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    want_loss, _, want_grads = step_lib.value_and_grad(model, params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    for a, b in zip(opt.tree_leaves(grads), opt.tree_leaves(want_grads)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


def _tokens(cfg, g, b=2, s=16):
    raw = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    return raw[:, :-1], raw[:, 1:]


@pytest.mark.cuda
def test_cuda_vlm_ring_prefill_and_grads_vs_cpu(cuda):
    """internvl2 SMOKE with patches on a ring of 2: the QKV, attention and
    FFN rings on the card, twice a block under remat "full"."""
    def batch(cfg, g):
        tokens, targets = _tokens(cfg, g)
        patches = torch.randn(2, cfg.num_patches, cfg.vit_dim, generator=g)
        return (tokens, patches), {"tokens": tokens, "targets": targets,
                                   "patch_embeds": patches}

    def expect(cfg):
        # prefill + forward + recompute: (QKV 3n + FFN 3n) and n hops
        return {"tile_matmul": 3 * cfg.num_layers * 12,
                "flash_carry": 3 * cfg.num_layers * 2}
    _family_vs_cpu(cuda, "internvl2-1b", 2, batch, expect)


@pytest.mark.cuda
def test_cuda_deepseek_ring_prefill_and_grads_vs_cpu(cuda):
    """deepseek SMOKE on a ring of 2: MLA and the MoE layers (shared
    experts) off the ring, layer 0's SwiGLU on the FFN ring."""
    def batch(cfg, g):
        tokens, targets = _tokens(cfg, g)
        return (tokens,), {"tokens": tokens, "targets": targets}

    def expect(cfg):
        return {"tile_matmul": 3 * cfg.first_k_dense * 6, "flash_carry": 0}
    _family_vs_cpu(cuda, "deepseek-v2-lite-16b", 2, batch, expect)


@pytest.mark.cuda
def test_cuda_whisper_ring_prefill_and_grads_vs_cpu(cuda):
    """whisper SMOKE on a ring of 2: the encoder's and the decoder's QKV
    rings and the decoder's ring attention on the card."""
    def batch(cfg, g):
        tokens, targets = _tokens(cfg, g)
        frames = torch.randn(2, cfg.enc_frames, cfg.d_model, generator=g)
        return ({"frames": frames, "tokens": tokens},), {
            "frames": frames, "tokens": tokens, "targets": targets}

    def expect(cfg):
        return {"tile_matmul": 3 * (cfg.enc_layers + cfg.num_layers) * 6,
                "flash_carry": 3 * cfg.num_layers * 2}
    _family_vs_cpu(cuda, "whisper-tiny", 2, batch, expect)


@pytest.mark.cuda
def test_cuda_whisper_prefill_vs_streamed_decode(cuda):
    """whisper SMOKE in fp32 on a ring of 2 on the card: encode, fill the
    cross cache, stream the prompt through ring decode attention; the last
    logits within 2e-3 of the prefill's."""
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = replace(get_smoke_config("whisper-tiny"), dtype="float32",
                  param_dtype="float32", systolic_mode="qlr")
    model = build_model(cfg, n_pe=2)
    params = model.init(0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    frames = torch.randn(2, cfg.enc_frames, cfg.d_model, generator=g,
                         device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                           device=cuda)
    before = fk.FLASH_CARRY.launches
    with torch.no_grad():
        want = model.prefill(params, {"frames": frames, "tokens": tokens})
        cache = model.fill_cross_cache(
            params, model.init_cache(2, 16, cuda), model.encode(params,
                                                                frames))
        for t in range(tokens.shape[1]):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    torch.cuda.synchronize()
    assert fk.FLASH_CARRY.launches - before == \
        cfg.num_layers * 2 * (1 + tokens.shape[1])
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# the block knob: (P, M, K, N) with ragged M and N = 64 (the narrowest
# wgmma width), and the serving FFN AG hop
BLOCK_SHAPES = {"ragged": (3, 500, 256, 64), "ffn_ag_hop": (4, 512, 1024, 768)}


@pytest.mark.cuda
@pytest.mark.parametrize("block", [0, 64, 128])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(BLOCK_SHAPES))
def test_cuda_tile_matmul_blocks_vs_twin(cuda, shape, dtype, carry, block):
    """Every forced tile (bf16: BN; fp32: the square tile) against the
    twin, at the bounds of ``test_cuda_tile_matmul_vs_twin``."""
    g = torch.Generator(device=cuda).manual_seed(9)
    p, m, k, n = BLOCK_SHAPES[shape]
    a = torch.randn(p, m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(p, k, n, generator=g, device=cuda).to(dtype)
    c = torch.randn(p, m, n, generator=g, device=cuda).to(dtype) \
        if carry else None
    got = mk.matmul_cuda(a, b, c, dtype, block)
    want = mk.matmul_plain(a, b, c, dtype)
    torch.cuda.synchronize()
    tol = (1e-4 if dtype == torch.float32 else 2 ** -7) \
        * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
    with pytest.raises(ValueError, match="block"):
        mk.matmul_cuda(a, b, c, dtype, 96)


@pytest.mark.cuda
def test_cuda_tune_three_matmul_plans_then_cache_hit(cuda, tmp_path):
    """One sweep over three kernel plans of the AG ring on the card: every
    plan timed, the winner persisted; the second lookup runs no trial."""
    from repro_torch.autotune import Plan, TuneCache, best_plan, tune
    from repro_torch.autotune import measure
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import topology as tp
    g = torch.Generator(device=cuda).manual_seed(10)
    n = 4
    x = torch.randn(n, 2, 256, 1024, generator=g, device=cuda).bfloat16()
    w = torch.randn(n, 1024, 768, generator=g, device=cuda).bfloat16()

    def build(plan):
        topo = tp.resolve_safe(plan.topology, "model", n)
        return (lambda a, b: cm.ring_ag_matmul(a, [b], topo, plan.mode,
                                               plan.block)[0], (x, w))

    plans = [Plan("qlr", "ring", 0, True), Plan("qlr", "ring", 64, True),
             Plan("xqueue", "snake_fold", 128, True)]
    cache = TuneCache(str(tmp_path / "c.json"))
    measure.reset_trials()
    launches = mk.TILE_MATMUL.launches
    winner, results = tune("matmul", (2, 4 * 256, 1024), "bfloat16", n,
                           build, cache=cache, plans=plans, iters=2)
    assert measure.trial_count() == 3
    assert all("error" not in r and 0 < r["us"] < float("inf")
               for r in results.values()), results
    assert all(r["bytes"] > 0 for r in results.values())
    assert mk.TILE_MATMUL.launches > launches
    assert winner in plans
    measure.reset_trials()
    assert best_plan("matmul", (2, 1024, 1024), "bfloat16", n,
                     cache=TuneCache(cache.path)) == winner
    assert measure.trial_count() == 0


# head_dim-224 hops (Zamba2-7B's shared attention, scale 1/sqrt(224 / 2)),
# heads cut: (ring size, batch, queries a PE, heads, KV heads, state)
HD224_HOPS = {
    "mha_carried": (4, 1, 256, 8, 8, "carried"),
    "gqa4_carried": (2, 2, 192, 8, 2, "carried"),
    "normalized": (4, 1, 256, 8, 8, "fresh"),
}
ZAMBA2_7B_SCALE = (224 / 2) ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(HD224_HOPS))
def test_cuda_flash_carry_head_dim224_hops(cuda, shape):
    """Ring-attention hops at head_dim 224 on the tensor-core body (q read
    from shared memory) at hop 1 with an explicit scale: the state within
    2e-4 of its scale of the twin's, the normalized form from zero state
    within 2e-2 of the twin's and of SDPA's at the same scale."""
    import torch.nn.functional as F
    n, b, s_l, h, kvh, state = HD224_HOPS[shape]
    g = torch.Generator(device=cuda).manual_seed(3)
    hd, bf, rows = 224, torch.bfloat16, n * b
    pe = torch.arange(n, device=cuda).repeat_interleave(b)
    q = torch.randn(rows, s_l, h, hd, generator=g, device=cuda).to(bf)
    k = torch.randn(rows, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    v = torch.randn(rows, s_l, kvh, hd, generator=g, device=cuda).to(bf)
    hop = 0 if state == "fresh" else 1
    if state == "fresh":
        m = torch.full((rows, h, s_l), -1e30, device=cuda)
        l = torch.zeros(rows, h, s_l, device=cuda)
        acc = torch.zeros(rows, h, s_l, hd, device=cuda)
    else:
        m = torch.randn(rows, h, s_l, generator=g, device=cuda)
        m[::3] = -1e30
        l = torch.rand(rows, h, s_l, generator=g, device=cuda) + 1
        acc = torch.randn(rows, h, s_l, hd, generator=g, device=cuda)
    big = torch.full((rows,), 2 ** 30, device=cuda)
    args = (q, k, v, m, l, acc, pe * s_l, (pe - hop) % n * s_l, big, None)
    opts = dict(causal=True, normalize=state == "fresh",
                out_dtype=bf if state == "fresh" else None,
                scale=ZAMBA2_7B_SCALE)
    before = fk.FLASH_CARRY.launches
    got = fk.flash_carry_cuda(*args, **opts)
    assert fk.FLASH_CARRY.launches == before + 1
    want = fk.flash_carry_plain(*args, **opts)
    torch.cuda.synchronize()
    scale = max(1.0, float(want[2].float().abs().max()))
    tol = 2e-2 if state == "fresh" else 2e-4
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        assert float((x.float() - y.float()).abs().max()) <= tol * scale
    if state == "fresh":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt, vt = (x.repeat_interleave(h // kvh, 1) for x in (kt, vt))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=ZAMBA2_7B_SCALE)
        assert float((sdpa.float() - got[2].float()).abs().max()) <= 2e-2


# head_dim-224 backward hops (Zamba2-7B's shared attention, heads cut):
# (query rows, queries a row, keys, heads, KV heads, hop, window, state,
# operand type); 4 PEs, one query row a PE. "ragged_t200": 200 keys, so the
# last 64-key tile is partly filled (192 would fill three); "zero_state":
# fresh state at hop 1, PE 0's rows still at the sentinel after it; the
# fp32 case runs the CUDA-core body
HD224_BWD = {
    "mha_carried": (4, 128, 128, 8, 8, 1, 0, "carried", "bf16"),
    "gqa4": (4, 128, 128, 8, 2, 1, 0, "carried", "bf16"),
    "ragged_t200": (4, 136, 200, 8, 8, 1, 0, "carried", "bf16"),
    "zero_state": (4, 128, 128, 8, 8, 1, 0, "zero", "bf16"),
    "window": (4, 128, 128, 8, 8, 1, 100, "carried", "bf16"),
    "hop0_diagonal": (4, 128, 128, 8, 8, 0, 0, "carried", "bf16"),
    "fp32": (4, 128, 128, 8, 8, 1, 0, "carried", "fp32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape, scale", [
    ("mha_carried", None), ("mha_carried", ZAMBA2_7B_SCALE),
    *((name, ZAMBA2_7B_SCALE) for name in HD224_BWD if name != "mha_carried")])
def test_cuda_flash_carry_head_dim224_grads(cuda, shape, scale):
    """The backward at head_dim 224 through ``_FlashCarry`` (bf16 q and
    K/V on the tensor-core body, fp32 on the CUDA-core body): one launch,
    bit-identical twice, within the bounds of
    ``test_cuda_flash_carry_grads_at_training_hop`` of the closed-form
    twin at the same scale (bf16 gradients 2^-7 of the largest, the state
    gradients 1e-5 and fp32 q/K/V gradients 1e-4 of max(1, the
    largest))."""
    rows, s_l, t, h, kvh, hop, window, state, dt = HD224_BWD[shape]
    g = torch.Generator(device=cuda).manual_seed(5)
    n, hd = 4, 224
    pe = torch.arange(n, device=cuda).repeat_interleave(rows // n)
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q = torch.randn(rows, s_l, h, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(rows, t, kvh, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(rows, t, kvh, hd, generator=g, device=cuda).to(dtype)
    if state == "zero":
        m = torch.full((rows, h, s_l), -1e30, device=cuda)
        l = torch.zeros(rows, h, s_l, device=cuda)
        acc = torch.zeros(rows, h, s_l, hd, device=cuda)
    else:
        m = torch.randn(rows, h, s_l, generator=g, device=cuda)
        m[::3] = -1e30
        l = torch.rand(rows, h, s_l, generator=g, device=cuda) + 1
        acc = torch.randn(rows, h, s_l, hd, generator=g, device=cuda)
    ints = (pe * s_l, (pe - hop) % n * s_l,
            torch.full((rows,), 2 ** 30, device=cuda), None)
    ins = (q, k, v, m, l, acc)
    diff = [x.clone().requires_grad_(True) for x in ins]
    outs = fk._FlashCarry.apply(*diff, *ints, True, window, False, None,
                                scale)
    ups = [torch.randn(x.shape, generator=g, device=cuda) for x in outs]
    before = fk.FLASH_CARRY_BWD.launches
    got = torch.autograd.grad(outs, diff, ups, retain_graph=True)
    assert fk.FLASH_CARRY_BWD.launches == before + 1
    again = torch.autograd.grad(outs, diff, ups)
    want = fk.flash_carry_backward_plain(
        *ins, *ints, *(o.detach() for o in outs), *ups, causal=True,
        window=window, scale=scale)
    torch.cuda.synchronize()
    for i, (x, y, z) in enumerate(zip(got, want, again)):
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, z), f"gradient {i} differs between calls"
        big = float(y.float().abs().max())
        if x.dtype == torch.bfloat16:
            tol = 2 ** -7 * big
        else:
            tol = (1e-5 if i >= 3 else 1e-4) * max(1.0, big)
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_carry_bwd_body_at_head_dim224(cuda):
    """The library's choice of body at head_dim 224: the tensor-core body
    for bf16 q and K/V with more than one query, the CUDA-core body for
    fp32 operands and for one query; pass B's resident blocks at 224 as the
    card reports them, at least one block (two warpgroups) an SM."""
    lib = fk.FLASH_CARRY_BWD.lib()
    assert lib.flash_carry_bwd_uses_mma(1, 1, 2, 224) == 1
    assert lib.flash_carry_bwd_uses_mma(1, 1, 512, 224) == 1
    assert lib.flash_carry_bwd_uses_mma(0, 0, 512, 224) == 0
    assert lib.flash_carry_bwd_uses_mma(1, 1, 1, 224) == 0
    assert lib.flash_carry_bwd_uses_mma(1, 1, 512, 192) == 0
    out = ctypes.c_int(0)
    fk.FLASH_CARRY_BWD.check(lib.flash_carry_bwd_keys_resident(
        224, ctypes.byref(out)))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert out.value >= sms
