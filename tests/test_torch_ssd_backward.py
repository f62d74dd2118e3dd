"""The SSD chunk pass's backward twin (``ssd_chunks_backward_plain``, the
plain version of ``csrc/ssd_chunks_bwd.cu``) against autograd of the
forward twin, and the port's SSD scan differentiated on the CPU (through
``_SSDChunks``' closed-form backward) against the reference's gradient:
``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` (the reference trains
through jnp autodiff; its Pallas SSD kernel has no VJP).

Inputs come from numpy with a seed. Bounds, relative to max(1, the largest
wanted value):

- the twin against autograd: fp32 1e-5 in each of the five gradients. bf16
  leaves get their gradients in bf16: the twin at bf16 inputs is its fp32
  gradient at the same (exact) values, rounded once, and that fp32
  gradient is held to the same bound;
- the scan against the reference: ``tests/test_torch_ssm.py``'s 1e-4.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import ref, to_torch  # noqa: F401 (fixture)
from test_torch_ssm import ARCH, TOL as SSM_TOL, _scan_inputs

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.models import ssm
from repro_torch.roofline import count

TOL = 1e-5
NAMES = ("dx", "ddt", "da", "db", "dc")


def _inputs(seed, bsz, h, g, nc, l, p, n, a_val=None, dt_shift=0.0):
    """Kernel-contract inputs (x, dt, a, b, c) and cotangents (gy, gs, ge)
    of its three outputs, as numpy fp32."""
    rng = np.random.default_rng(seed)
    bh, bg = bsz * h, bsz * g

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x = rand(bh, nc, l, p)
    dt = np.log1p(np.exp(rand(bh, nc, l, 1) + dt_shift)).astype(np.float32)
    a_h = np.full(h, a_val, np.float32) if a_val is not None \
        else -np.exp(rand(h) * 0.3)
    a = np.broadcast_to(a_h[None], (bsz, h)).reshape(bh, 1, 1, 1)
    b, c = rand(bg, nc, l, n) * 0.3, rand(bg, nc, l, n) * 0.3
    cots = (rand(bh, nc, l, p), rand(bh, nc, p, n), rand(bh, nc, l, 1))
    return (x, dt, a.astype(np.float32), b, c), cots


def _autograd(ins, cots, h, g):
    """Autograd of the forward twin at fp32 leaves; a None cotangent drops
    its output."""
    leaves = [t.float().detach().requires_grad_(True) for t in ins]
    outs = sk.ssd_chunks_plain(*leaves, nheads=h, ngroups=g)
    pairs = [(o, u) for o, u in zip(outs, cots) if u is not None]
    got = torch.autograd.grad([o for o, _ in pairs], leaves,
                              [u for _, u in pairs], allow_unused=True)
    return [torch.zeros_like(leaf) if x is None else x
            for x, leaf in zip(got, leaves)]


def _close(got, want, tol=TOL):
    for name, x, y in zip(NAMES, got, want):
        assert x.shape == y.shape, name
        assert bool(torch.isfinite(x).all()), name
        bound = tol * max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x.float(), y.float(), rtol=0, atol=bound,
                                   msg=lambda m, name=name: f"{name}: {m}")


# (batch, heads, groups, chunks, L, P, N): heads per group 1, 2 and 4
CASES = {
    "g1_hpg4_l16": (2, 4, 1, 3, 16, 8, 16),
    "g2_hpg2_l32": (2, 4, 2, 2, 32, 16, 8),
    "g2_hpg1_l32": (1, 2, 2, 3, 32, 8, 8),
    "g1_hpg2_l256": (1, 2, 1, 2, 256, 16, 16),
    "g2_hpg2_l256": (1, 4, 2, 1, 256, 8, 24),
    "ragged_13_37": (2, 4, 2, 2, 16, 13, 37),
    "ragged_l256": (1, 2, 1, 1, 256, 13, 37),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_twin_vs_autograd(case):
    bsz, h, g, nc, l, p, n = CASES[case]
    ins, cots = _inputs(sum(CASES[case]), bsz, h, g, nc, l, p, n)
    ins, cots = [to_torch(x) for x in ins], [to_torch(x) for x in cots]
    got = sk.ssd_chunks_backward_plain(*ins, *cots, nheads=h, ngroups=g)
    for x, leaf in zip(got, ins):
        assert x.dtype == leaf.dtype == torch.float32
    _close(got, _autograd(ins, cots, h, g))


@pytest.mark.parametrize("drop", [0, 1, 2], ids=["gy", "gs", "ge"])
def test_backward_twin_none_cotangent(drop):
    """A None cotangent counts as zero: the gradient of the other two
    outputs alone."""
    h, g = 4, 2
    ins, cots = _inputs(7, 2, h, g, 2, 32, 13, 37)
    ins = [to_torch(x) for x in ins]
    cots = [None if i == drop else to_torch(x) for i, x in enumerate(cots)]
    got = sk.ssd_chunks_backward_plain(*ins, *cots, nheads=h, ngroups=g)
    _close(got, _autograd(ins, cots, h, g))


def test_backward_twin_overflow_case_is_finite():
    """a = -4 and dt shifted by 1: cum reaches about -1300 in a chunk of
    256, exp(cum) underflows and exp(cum[t] - cum[s]) above the diagonal
    overflows. Every gradient stays finite (the reference's dt gradient
    is NaN there: ROADMAP §3) and equals autograd's."""
    h, g = 2, 1
    ins, cots = _inputs(8, 1, h, g, 2, 256, 16, 32, a_val=-4.0, dt_shift=1.0)
    ins, cots = [to_torch(x) for x in ins], [to_torch(x) for x in cots]
    got = sk.ssd_chunks_backward_plain(*ins, *cots, nheads=h, ngroups=g)
    _close(got, _autograd(ins, cots, h, g))


def test_fp32_twin_da_misses_its_float64_value():
    """Why the card holds the backward kernel against the twin's autograd
    taken in float64: at the overflow case the fp32 twin's own da is more
    than 1e-4 of its largest from the float64 value (da sums dt R, and
    every R[s] sums the dcum of the rows after s), while its other
    gradients are within 1e-6."""
    h, g = 2, 1
    ins, cots = _inputs(8, 1, h, g, 2, 256, 16, 32, a_val=-4.0, dt_shift=1.0)
    ins, cots = [to_torch(x) for x in ins], [to_torch(x) for x in cots]
    narrow = _autograd(ins, cots, h, g)
    wide = [t.double().requires_grad_(True) for t in ins]
    outs = sk.ssd_chunks_plain(*wide, nheads=h, ngroups=g)
    assert all(o.dtype == torch.float64 for o in outs)
    want = torch.autograd.grad(outs, wide, [u.double() for u in cots])
    err = {name: float((x.double() - y).abs().max())
           / max(1.0, float(y.abs().max()))
           for name, x, y in zip(NAMES, narrow, want)}
    assert err["da"] > 1e-4, err
    assert max(v for k, v in err.items() if k != "da") < 1e-6, err


@pytest.mark.parametrize("l", [16, 256])
def test_backward_twin_bf16_leaves(l):
    """bf16 x, B and C: dx, dB and dC in bf16, ddt and da in fp32; each is
    the fp32 gradient at the same values rounded once, and that gradient
    is autograd's within the bound."""
    h, g = 4, 2
    ins, cots = _inputs(9 + l, 1, h, g, 2, l, 16, 24)
    ins = [to_torch(x) for x in ins]
    for i in (0, 3, 4):
        ins[i] = ins[i].bfloat16()
    cots = [to_torch(x) for x in cots]
    got = sk.ssd_chunks_backward_plain(*ins, *cots, nheads=h, ngroups=g)
    wide = sk.ssd_chunks_backward_plain(*(t.float() for t in ins), *cots,
                                        nheads=h, ngroups=g)
    for x, y, leaf in zip(got, wide, ins):
        assert x.dtype == leaf.dtype and x.shape == leaf.shape
        assert torch.equal(x, y.to(leaf.dtype))
    _close(wide, _autograd(ins, cots, h, g))


def _ref_vjp(args, state, ups, assoc):
    from repro.configs.base import ModelConfig as RModelConfig
    from repro.models.ssm import ssd_chunked as r_chunked
    rcfg = RModelConfig(ssm_chunk=16)

    def f(*xs):
        *core, init = xs if state is not None else (*xs, None)
        return r_chunked(*core, rcfg, assoc_scan=assoc, initial_state=init,
                         return_final_state=True)
    prim = [jnp.asarray(a) for a in args]
    if state is not None:
        prim.append(jnp.asarray(state))
    _, vjp = jax.vjp(f, *prim)
    return vjp(tuple(jnp.asarray(u) for u in ups))


@pytest.mark.parametrize("assoc", [False, True], ids=["chain", "assoc"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_scan_gradient_vs_reference(ref, assoc, init):
    """The port's SSD scan on the CPU (``ops.ssd`` through
    ``_SSDChunks``, whose backward is the closed-form twin) differentiated
    in x, dt, A, B, C, D and the initial state for random cotangents of y
    and the final state, against ``jax.vjp`` of the reference's
    ``ssd_chunked``."""
    bsz, s, h, p, g, n = 2, 64, 4, 8, 2, 16
    args = _scan_inputs(11, bsz, s, h, p, g, n)
    rng = np.random.default_rng(12)
    state = rng.standard_normal((bsz, h, p, n)).astype(np.float32) \
        if init else None
    ups = (rng.standard_normal((bsz, s, h, p)).astype(np.float32),
           rng.standard_normal((bsz, h, p, n)).astype(np.float32))
    cfg = replace(get_smoke_config(ARCH), ssm_chunk=16)
    leaves = [to_torch(a).requires_grad_(True) for a in args]
    if init:
        leaves.append(to_torch(state).requires_grad_(True))
    with count.Counter() as cnt:
        outs = ssm.ssd_chunked(*leaves[:6], cfg, assoc_scan=assoc,
                               initial_state=leaves[6] if init else None,
                               return_final_state=True)
        got = torch.autograd.grad(outs, leaves, [to_torch(u) for u in ups])
    assert cnt.aggregate()["by_kernel"]["ssd_chunks_bwd"]["launches"] == 1
    want = _ref_vjp(args, state, ups, assoc)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        y = to_torch(y)
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        bound = SSM_TOL * max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x, y, rtol=0, atol=bound)


def test_function_backward_runs_the_twin_once_on_the_cpu():
    """On the CPU, ``ssd_chunks`` goes through ``_SSDChunks``: its backward
    is the closed-form twin (bit for bit), and a counter records one
    ``ssd_chunks_bwd`` launch with its work and none of the twin's ops (no
    aten op of autograd through the forward twin)."""
    h, g = 4, 2
    ins, cots = _inputs(13, 2, h, g, 2, 32, 8, 16)
    leaves = [to_torch(x).requires_grad_(True) for x in ins]
    ups = [to_torch(x) for x in cots]
    with count.Counter() as c:
        outs = sk.ssd_chunks(*leaves, nheads=h, ngroups=g)
        got = torch.autograd.grad(outs, leaves, ups)
    agg = c.aggregate()
    flops, moved, _ = sk.backward_work(*leaves, nheads=h, ngroups=g)
    assert agg["by_kernel"]["ssd_chunks_bwd"] == {
        "launches": 1, "flops": flops, "bytes": moved}
    assert agg["by_kernel"]["ssd_chunks"]["launches"] == 1
    assert not agg["by_op"], agg["by_op"]
    want = sk.ssd_chunks_backward_plain(*(x.detach() for x in leaves), *ups,
                                        nheads=h, ngroups=g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_backward_work_counts_the_causal_triangles():
    """C Bᵀ's causal triangle once per (group row, chunk); per (head row,
    chunk) four triangles of the products that give dM, dx, dC and dB, and
    the two full products B gsᵀ and x gs; the bytes of every input, every
    cotangent and every gradient once."""
    bf = torch.bfloat16
    bh, bg, nc, l, p, n = 8, 2, 3, 64, 16, 32
    x = torch.empty(bh, nc, l, p, dtype=bf, device="meta")
    dt = torch.empty(bh, nc, l, 1, device="meta")
    a = torch.empty(bh, 1, 1, 1, device="meta")
    b = torch.empty(bg, nc, l, n, dtype=bf, device="meta")
    flops, moved, kind = sk.backward_work(x, dt, a, b, b, nheads=4,
                                          ngroups=1)
    tri = l * (l + 1) // 2
    assert kind == "bf16"
    assert flops == bg * nc * 2 * tri * n + bh * nc * (
        2 * tri * (2 * p + 2 * n) + 4 * l * p * n)
    inputs = bh * nc * l * p * 2 + bh * nc * l * 4 + bh * 4 \
        + 2 * bg * nc * l * n * 2
    assert moved == 2 * inputs + 4 * bh * nc * (l * p + p * n + l)
    assert sk.backward_work(x.float(), dt, a, b.float(), b.float(), nheads=4,
                            ngroups=1)[2] == "fp32"
