"""The Mamba2 layer's causal conv as a kernel pair
(``repro_torch/kernels/causal_conv``): the wrapper's CPU path, the choice
of body and row tile, the closed-form backward twin against autograd, and
on the card the two kernels against their twins.

    python -m pytest -q tests/test_torch_causal_conv.py            # CPU
    python -m pytest -q -m cuda tests/test_torch_causal_conv.py    # card

The forward kernel rounds every product and partial sum as the eager twin
does, so on the card it equals the twin bit for bit in both types. The
backward sums in fp32 and rounds once: it is held to float64 autograd of
the twin at the Mamba2 layer's tolerances (fp32 1e-4, bf16 2e-2, relative
to max(1, the largest)). The file imports no JAX.
"""
from __future__ import annotations

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.causal_conv import kernel as cc
from repro_torch.models import ssm
from repro_torch.roofline import count

F64 = torch.float64
BF = torch.bfloat16
# mamba2-1.3b: in_proj width 2 * 4096 + 2 * 128 + 64, conv columns from 4096
MAMBA_WIDTH, MAMBA_OFFSET, MAMBA_C = 8512, 4096, 4352


def _inputs(b, s, c, k, dtype=F64, *, width=None, offset=0, seed=0,
            device="cpu"):
    """x as columns [offset, offset + c) of a wider row (the layer's
    input projection), w [K,C] and bias [C]."""
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn(b, s, width or c, generator=g, dtype=F64)
    w = torch.randn(k, c, generator=g, dtype=F64) * 0.5
    bias = torch.randn(c, generator=g, dtype=F64) * 0.1
    wide, w, bias = (t.to(device, dtype) for t in (wide, w, bias))
    return wide[..., offset:offset + c], w, bias


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(cc, name)

    def counted(*args):
        calls.append(name)
        return fn(*args)
    monkeypatch.setattr(cc, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_twin(monkeypatch):
    """On the CPU the wrapper runs ``_causal_conv`` (the reference's) and,
    backward, the closed-form twin: one call each, no launch."""
    fwd = _counting(monkeypatch, "causal_conv_plain")
    bwd = _counting(monkeypatch, "causal_conv_backward_plain")
    before = cc.CAUSAL_CONV.launches, cc.CAUSAL_CONV_BWD.launches
    x, w, bias = _inputs(2, 9, 24, 4, torch.float32, width=40, offset=8)
    leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
    y = cc.causal_conv(*leaves)
    assert torch.equal(y, ssm._causal_conv(x, w, bias))
    assert y.is_contiguous() and y.shape == x.shape
    torch.autograd.grad(y.sum(), leaves)
    assert (fwd, bwd) == (["causal_conv_plain"],
                          ["causal_conv_backward_plain"])
    assert (cc.CAUSAL_CONV.launches, cc.CAUSAL_CONV_BWD.launches) == before


def test_mixed_devices_raise():
    """No fallback: tensors on a CPU and another device go to the kernel
    path, which refuses them."""
    x, w, bias = _inputs(1, 4, 8, 4, torch.float32)
    g = torch.ones_like(x)
    with pytest.raises(ValueError, match="CUDA device"):
        cc.causal_conv(x, w.to("meta"), bias)
    with pytest.raises(ValueError, match="CUDA device"):
        cc.causal_conv_backward(x, w, bias.to("meta"), g)


def test_counter_counts_one_launch_each_way():
    """Under a counter (the dry run's) the forward and the backward are one
    launch each with their ``work``, and the twins' ops are muted."""
    x, w, bias = _inputs(2, 16, 32, 4, torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
    with count.Counter() as c:
        y = cc.causal_conv(*leaves)
        torch.autograd.grad(y, leaves, torch.ones_like(y))
    kernels = c.aggregate()["by_kernel"]
    assert kernels["causal_conv"]["launches"] == 1
    assert kernels["causal_conv_bwd"]["launches"] == 1
    assert kernels["causal_conv"]["flops"] == 9 * x.numel()
    by_op = c.aggregate()["by_op"]
    assert not any("silu" in op or "sigmoid" in op for op in by_op), by_op


def test_fake_cuda_tensors_allocate_only(monkeypatch):
    """A dry run's fake ``cuda`` tensors through the forward wrapper and the
    backward: outputs of the right shapes on the device, no build, no
    library call, no launch. (The autograd engine is not run on fake
    ``cuda`` tensors here: a CPU build of PyTorch has no CUDA streams.)"""
    for k in (cc.CAUSAL_CONV, cc.CAUSAL_CONV_BWD):
        monkeypatch.setattr(k, "lib", lambda: pytest.fail("library called"))
    before = cc.CAUSAL_CONV.launches, cc.CAUSAL_CONV_BWD.launches
    with FakeTensorMode():
        # x strided as the layer's view of its input projection (indexing a
        # fake cuda tensor raises on a CPU build, so made strided)
        x = torch.empty_strided((2, 8, 16), (192, 24, 1), dtype=BF,
                                device="cuda")
        w = torch.empty(4, 16, dtype=BF, device="cuda")
        bias = torch.empty(16, dtype=BF, device="cuda")
        y = cc.causal_conv(x, w, bias)
        grads = cc.causal_conv_backward(x, w, bias, torch.ones_like(y))
    assert tuple(y.shape) == (2, 8, 16) and y.device.type == "cuda"
    assert [tuple(t.shape) for t in grads] == [(2, 8, 16), (4, 16), (16,)]
    assert all(t.device.type == "cuda" for t in grads)
    assert (cc.CAUSAL_CONV.launches, cc.CAUSAL_CONV_BWD.launches) == before


# ---------------------------------------------------------------------------
# the choice of body and of row tile
# ---------------------------------------------------------------------------

BASE = 1 << 40                                     # a 16-byte aligned address
BODY_CASES = {
    # (B, S, C), strides, itemsize, offset of x in elements, want
    "mamba2_view_bf16": ((4, 2048, MAMBA_C),
                         (2048 * MAMBA_WIDTH, MAMBA_WIDTH, 1), 2,
                         MAMBA_OFFSET, True),
    "mamba2_view_fp32": ((4, 2048, MAMBA_C),
                         (2048 * MAMBA_WIDTH, MAMBA_WIDTH, 1), 4,
                         MAMBA_OFFSET, True),
    "zamba2_view_bf16": ((4, 2048, 4224), (2048 * 8320, 8320, 1), 2, 4096,
                         True),
    "smoke_view_bf16": ((2, 32, 160), (32 * 296, 296, 1), 2, 128, True),
    "contiguous_fp32": ((2, 33, 20), (33 * 20, 20, 1), 4, 0, True),
    "ragged_width": ((2, 32, 50), (32 * 50, 50, 1), 2, 0, False),
    "odd_row_stride": ((4, 2048, MAMBA_C), (2048 * 8513, 8513, 1), 2,
                       MAMBA_OFFSET, False),
    "odd_batch_stride": ((4, 2048, MAMBA_C),
                         (2048 * MAMBA_WIDTH + 4, MAMBA_WIDTH, 1), 2,
                         MAMBA_OFFSET, False),
    "odd_offset": ((4, 2048, MAMBA_C), (2048 * MAMBA_WIDTH, MAMBA_WIDTH, 1),
                   2, MAMBA_OFFSET + 1, False),
    "fp32_half_vector_offset": ((2, 8, 64), (8 * 72, 72, 1), 4, 2, False),
    "one_row_any_strides": ((1, 1, 64), (7, 3, 1), 2, 0, True),
}


@pytest.mark.parametrize("case", sorted(BODY_CASES))
def test_body_choice(case):
    shape, strides, size, offset, want = BODY_CASES[case]
    addresses = (BASE + offset * size, BASE, BASE + 4096, BASE + 8192)
    assert cc.conv_vector(shape, strides, size, addresses) is want


def test_body_choice_reads_every_pointer():
    """An output, w or bias off a 16-byte boundary takes the generic body."""
    shape, strides, size, offset, _ = BODY_CASES["mamba2_view_bf16"]
    x_at = BASE + offset * size
    for bad in range(1, 4):
        addresses = [x_at, BASE, BASE + 4096, BASE + 8192]
        addresses[bad] += 8
        assert not cc.conv_vector(shape, strides, size, addresses)


TILE_CASES = {
    # (B, S, threads a row, resident blocks, waves), rows a thread: the
    # forward at 122 registers (4 blocks of 128 an SM), the backward at 150
    # (3 an SM), as built for an H100
    "mamba2_prefill_fwd": ((4, 2048, MAMBA_C // 8, 528, cc.WAVES), 8),
    "mamba2_train_fwd": ((8, 2048, MAMBA_C // 8, 528, cc.WAVES), 16),
    "mamba2_prefill_bwd": ((4, 2048, MAMBA_C // 4, 396, cc.BWD_WAVES), 64),
    "mamba2_train_bwd": ((8, 2048, MAMBA_C // 4, 396, cc.BWD_WAVES), 64),
    "small": ((2, 32, 20, 528, cc.WAVES), 8),
    "two_waves_at_32": ((4, 2048, MAMBA_C // 8, 528, 2), 32),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_row_tile(case):
    """The largest tile whose grid fills the waves asked for, else the
    smallest."""
    (b, s, per_row, resident, waves), want = TILE_CASES[case]
    tile = cc.row_tile(b, s, per_row, resident, waves)
    assert tile == want
    blocks = -(-b * -(-s // tile) * per_row // cc.THREADS)
    assert blocks >= waves * resident or tile == cc.TILES[-1]
    larger = [t for t in cc.TILES if t > tile]
    assert all(-(-b * -(-s // t) * per_row // cc.THREADS) < waves * resident
               for t in larger)


# ---------------------------------------------------------------------------
# the closed-form backward
# ---------------------------------------------------------------------------

BWD_CASES = {"k4_one_row": (4, 1), "k4_short": (4, 3), "k4_s_equal_k": (4, 4),
             "k4_ragged": (4, 37), "k3": (3, 64), "k2_ragged": (2, 17),
             "k1": (1, 5)}


def _autograd(x, w, bias, g):
    leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
    return torch.autograd.grad(ssm._causal_conv(*leaves), leaves, g)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_plain_vs_autograd(case):
    """``causal_conv_backward_plain`` in float64 against autograd of
    ``_causal_conv``, x a strided view, for each K, S < K and ragged S."""
    k, s = BWD_CASES[case]
    x, w, bias = _inputs(3, s, 24, k, width=40, offset=8, seed=s)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7),
                    dtype=F64)
    got = cc.causal_conv_backward_plain(x, w, bias, g)
    want = _autograd(x, w, bias, g)
    for name, a, b in zip(("dx", "dw", "dbias"), got, want):
        assert a.dtype == F64 and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_function_gradients_vs_autograd(dtype):
    """``causal_conv``'s gradients (``_CausalConv`` with the closed-form
    twin) against autograd of the twin, through the layer's strided view:
    float64 1e-12, fp32 1e-5 of the largest."""
    wide = torch.randn(2, 21, 40, generator=torch.Generator().manual_seed(5),
                       dtype=dtype, requires_grad=True)
    _, w, bias = _inputs(2, 21, 24, 4, dtype)
    w, bias = w.requires_grad_(True), bias.requires_grad_(True)
    up = torch.randn(2, 21, 24, generator=torch.Generator().manual_seed(6),
                     dtype=dtype)
    got = torch.autograd.grad(cc.causal_conv(wide[..., 8:32], w, bias),
                              [wide, w, bias], up)
    want = torch.autograd.grad(ssm._causal_conv(wide[..., 8:32], w, bias),
                               [wide, w, bias], up)
    tol = 1e-12 if dtype == F64 else 1e-5
    for name, a, b in zip(("x", "w", "bias"), got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=tol * scale, msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


# (B, S, C, row width, offset, K), vector body: the mamba2-1.3b layer
# through its strided input projection; a ragged width at an odd offset
# (the generic body); S < K; S a multiple of no row tile; a narrower conv
CARD_CASES = {"mamba2_layer": ((2, 2048, MAMBA_C, MAMBA_WIDTH, MAMBA_OFFSET,
                                4), True),
              "generic": ((3, 100, 50, 61, 3, 4), False),
              "short": ((2, 2, MAMBA_C, MAMBA_WIDTH, MAMBA_OFFSET, 4), True),
              "ragged_rows": ((2, 77, MAMBA_C, MAMBA_WIDTH, MAMBA_OFFSET, 4),
                              True),
              "k3": ((2, 77, MAMBA_C, MAMBA_WIDTH, MAMBA_OFFSET, 3), True)}


def _card_inputs(case, dtype, dev, seed=0):
    (b, s, c, width, offset, k), vector = CARD_CASES[case]
    x, w, bias = _inputs(b, s, c, k, dtype, width=width, offset=offset,
                         seed=seed, device=dev)
    addresses = [t.data_ptr() for t in (x, w, bias)] + [0]
    assert cc.conv_vector(x.shape, x.stride(), x.element_size(),
                          addresses) is vector
    return x, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_causal_conv_bit_for_bit(cuda, dtype, case):
    """The forward kernel equals the twin run on the card bit for bit, at
    the row tile it picks and at each forced tile; one launch a call."""
    x, w, bias = _card_inputs(case, dtype, cuda)
    want = cc.causal_conv_plain(x, w, bias)
    for tile in (0, *cc.TILES):
        before = cc.CAUSAL_CONV.launches
        got = cc.causal_conv_cuda(x, w, bias, tile=tile)
        torch.cuda.synchronize()
        assert cc.CAUSAL_CONV.launches == before + 1
        assert got.is_contiguous() and got.dtype == dtype
        assert torch.equal(got, want), (tile, float(
            (got.float() - want.float()).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_causal_conv_backward_vs_float64(cuda, dtype, case):
    """The backward kernel against float64 autograd of the twin at the same
    values: fp32 1e-4, bf16 2e-2 of max(1, the largest); the same bits on
    a second call; one launch a call."""
    x, w, bias = _card_inputs(case, dtype, cuda, seed=1)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(2), device=cuda).to(dtype)
    before = cc.CAUSAL_CONV_BWD.launches
    got = cc.causal_conv_backward_cuda(x, w, bias, g)
    again = cc.causal_conv_backward_cuda(x, w, bias, g)
    torch.cuda.synchronize()
    assert cc.CAUSAL_CONV_BWD.launches == before + 2
    want = _autograd(x.double(), w.double(), bias.double(), g.double())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, a2, b in zip(("dx", "dw", "dbias"), got, again, want):
        assert a.dtype == dtype and torch.equal(a, a2), name
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a.double(), b, rtol=0, atol=tol * scale,
                                   msg=name)
