"""The port's CUDA kernels against their plain twins, on the card.

CUDA kernels have no CPU mode: every test here needs an NVIDIA GPU and
``nvcc`` and skips elsewhere. The file imports no JAX, so it runs on a
machine with only PyTorch and CUDA::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 results differ from the twin only in the order of fp32
sums (1e-4); bf16 results add one bf16 rounding (2e-2).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk
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
