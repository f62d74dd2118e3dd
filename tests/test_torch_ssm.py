"""The port's Mamba2 slice against the JAX reference, on the CPU.

Inputs come from numpy seeds and go through both packages. Bounds, from
the reference's own tests (``tests/test_kernels.py``, ``tests/test_parity.py``):

- the SSD chunk pass (the kernel's plain twin against the Pallas kernel in
  interpret mode) and the full SSD scan against the reference's: 1e-4,
  relative to the largest output;
- the SSD scan against the sequential recurrence ``ssd_sequential_ref``:
  1e-3;
- a Mamba2 layer in fp32: 1e-4; in bf16: 2e-2, the tightest bf16 bound of
  ``tests/test_kernels.py``. One layer rounds to bf16 at the in
  projection, the conv taps, the SSD output and the out projection; the
  measured errors at these tests' seeds are 1.12e-2 (prefill) and 9.7e-3
  (decode, outputs and state), and 8.3e-3 to 1.75e-2 for prefill over
  four input seeds;
- the causal conv elementwise, relative to each value: 1e-6 in fp32,
  2^-6 in bf16. Its taps and bias are summed in the reference's order and
  rounding, so the value before silu is the reference's bit for bit;
  silu then rounds once in torch where XLA rounds each step of the
  sigmoid (measured 9.9e-3 over ten seeds). Taps summed in fp32 instead
  exceed 1 there, which the layer's 2e-2 bound could not show;
- prefill against decode, in the port alone: 2e-3 (``test_parity.py``).

The CUDA kernel is held to this twin on the card by
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import (  # noqa: F401 (fixture)
    ref,
    reference_model,
    smoke_fp32,
)
from test_torch_serve import SCFG, _drive, _schedule, assert_lockstep

from repro_torch.configs import ServeConfig, get_config, get_smoke_config
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models import build_model, params_from_reference, \
    params_to_reference
from repro_torch.models import ssm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sharded_cache import DecodeBackend

ARCH = "mamba2-1.3b"
TOL = 1e-4
SEQ_TOL = 1e-3
BF16_TOL = 2e-2
CONV_RTOL = {"float32": 1e-6, "bfloat16": 2.0 ** -6}
PARITY_TOL = 2e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _chunk_inputs(seed, bsz, h, g, nc, l, p, n, a_scale=0.3, dt_shift=0.0):
    """Kernel-contract inputs (numpy): x, dt, a, b, c."""
    rng = np.random.default_rng(seed)
    bh, bg = bsz * h, bsz * g
    x = rng.standard_normal((bh, nc, l, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, nc, l, 1)) + dt_shift))
    a_h = -np.exp(rng.standard_normal(h) * a_scale)
    a = np.broadcast_to(a_h[None], (bsz, h)).reshape(bh, 1, 1, 1)
    b = (rng.standard_normal((bg, nc, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bg, nc, l, n)) * 0.3).astype(np.float32)
    return (x, dt.astype(np.float32), a.astype(np.float32), b, c)


def _reference_chunks(args, h, g):
    from repro.kernels.ssd.kernel import ssd_chunks
    return ssd_chunks(*map(jnp.asarray, args), nheads=h, ngroups=g,
                      interpret=True)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l", [16, 32])
def test_ssd_chunks_twin_vs_reference(ref, g, l):
    h = 4
    args = _chunk_inputs(0, 2, h, g, 3, l, 8, 16)
    before = sk.SSD_CHUNKS.launches
    got = sk.ssd_chunks(*map(_t, args), nheads=h, ngroups=g)
    assert sk.SSD_CHUNKS.launches == before     # CPU tensors: the twin
    for x, y in zip(got, _reference_chunks(args, h, g)):
        _close(x, y, TOL)


def test_ssd_chunks_overflow_case_is_finite(ref):
    """L=256 with |dt * a| ~ 1 per step, as at full width with random
    weights: cum falls to about -200, so exp(cum[t] - cum[s]) above the
    diagonal overflows; the select keeps it out of the output."""
    h, l = 2, 256
    args = _chunk_inputs(1, 1, h, 1, 1, l, 8, 16, a_scale=0.0)
    _, dt, a, _, _ = args
    cum = np.cumsum(dt[..., 0] * a[..., 0], axis=-1)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(-cum.min())))
    got = sk.ssd_chunks_plain(*map(_t, args), nheads=h, ngroups=1)
    for x_, y in zip(got, _reference_chunks(args, h, 1)):
        _close(x_, y, TOL)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """t = hi + lo in two bf16 halves, rounded as the kernel's split_bf16:
    hi the nearest bf16, lo the nearest bf16 of the fp32 remainder."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _tensor_core_scheme(x, dt, a, b, c, split_m: bool = True, tile=64):
    """The bf16 body of ``csrc/ssd_chunks.cu`` emulated in fp32 (G = 1):
    bf16 C and B, S = C B^T with fp32 sums, M = S * decay * dt in fp32
    (below the diagonal tile, (S * exp(cum[t] - cum[e])) * (exp(cum[e] -
    cum[s]) * dt[s]) with e the last row of s's tile), M split into hi + lo
    (or, with ``split_m`` off, rounded once to bf16), x in bf16, y = M_hi x
    + M_lo x and states = (x w)_hi^T B + (x w)_lo^T B with fp32 sums."""
    l = x.shape[2]
    dtf = dt[..., 0]
    cum = torch.cumsum((dtf * a.reshape(-1, 1, 1)).double(), -1).float()
    mask = torch.ones(l, l, dtype=torch.bool).tril()
    decay = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
    s = torch.matmul(c, b.transpose(-1, -2))                 # [1, NC, L, L]
    m = s * decay * dtf[..., None, :]
    pos = torch.arange(l)
    last = (pos | (tile - 1)).clamp(max=l - 1)               # e of column s
    row_f = torch.exp(cum[..., :, None] - cum[..., last][..., None, :])
    col_f = torch.exp(cum[..., last] - cum) * dtf
    below = (pos[:, None] // tile) > (pos[None, :] // tile)
    m = torch.where(below, s * row_f * col_f[..., None, :], m)
    if split_m:
        m_hi, m_lo = _split(m)
        y = torch.matmul(m_hi, x) + torch.matmul(m_lo, x)
    else:
        y = torch.matmul(_bf16(m), x)
    w = torch.exp(cum[..., -1:] - cum) * dtf
    xw_hi, xw_lo = _split(x * w[..., None])
    states = torch.matmul(xw_hi.transpose(-1, -2), b) \
        + torch.matmul(xw_lo.transpose(-1, -2), b)
    return y, states


def test_ssd_tensor_core_scheme_needs_the_split():
    """At the prefill shape (L=256, P=64, N=128) with the overflow case's
    a = -4: the bf16 tensor-core scheme with M split into two bf16 halves
    stays within the reference's 1e-4 * |out|max of the fp32 twin; one
    bf16 rounding of M does not. This guards the kernel's design."""
    h = 4
    x, dt, _, b, c = map(_t, _chunk_inputs(2, 1, h, 1, 2, 256, 64, 128,
                                           dt_shift=1.0))
    a = torch.full((h, 1, 1, 1), -4.0)
    x, b, c = _bf16(x), _bf16(b), _bf16(c)
    y_want, s_want, _ = sk.ssd_chunks_plain(
        x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(), nheads=h, ngroups=1)
    y, states = _tensor_core_scheme(x, dt, a, b, c)
    _close(y, y_want, TOL)
    _close(states, s_want, TOL)
    y_once, _ = _tensor_core_scheme(x, dt, a, b, c, split_m=False)
    scale = max(1.0, float(y_want.abs().max()))
    assert float((y_once - y_want).abs().max()) > TOL * scale


def _scan_inputs(seed, bsz, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((bsz, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, s, g, n)) * 0.3).astype(np.float32)
    d = np.ones(h, np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_vs_reference(ref, s, chunk, g):
    from repro.kernels.ssd.ops import ssd as r_ssd
    from repro.kernels.ssd.ref import ssd_sequential_ref
    args = _scan_inputs(2, 2, s, 4, 8, g, 16)
    got = ssd(*map(_t, args), chunk=chunk)
    _close(got, r_ssd(*map(jnp.asarray, args), chunk=chunk), TOL)
    _close(got, ssd_sequential_ref(*map(jnp.asarray, args)), SEQ_TOL)


@pytest.mark.parametrize("assoc", [False, True], ids=["chain", "assoc"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_ssd_chunked_vs_reference(ref, assoc, init):
    from repro.configs.base import ModelConfig as RModelConfig
    from repro.models.ssm import ssd_chunked as r_chunked
    bsz, s, h, p, g, n = 2, 64, 4, 8, 2, 16
    args = _scan_inputs(3, bsz, s, h, p, g, n)
    state = np.random.default_rng(4).standard_normal(
        (bsz, h, p, n)).astype(np.float32) if init else None
    rcfg = RModelConfig(ssm_chunk=16)
    cfg = replace(get_smoke_config(ARCH), ssm_chunk=16)
    got_y, got_s = ssm.ssd_chunked(
        *map(_t, args), cfg, assoc_scan=assoc,
        initial_state=None if state is None else _t(state),
        return_final_state=True)
    want_y, want_s = r_chunked(
        *map(jnp.asarray, args), rcfg, assoc_scan=assoc,
        initial_state=None if state is None else jnp.asarray(state),
        return_final_state=True)
    _close(got_y, want_y, TOL)
    _close(got_s, want_s, TOL)
    only_y = ssm.ssd_chunked(*map(_t, args), cfg, assoc_scan=assoc,
                             initial_state=None if state is None
                             else _t(state))
    assert torch.equal(only_y, got_y)


def test_ssd_chunked_rejects_ragged_sequence():
    cfg = replace(get_smoke_config(ARCH), ssm_chunk=16)
    x, dt, a, b, c, d = map(_t, _scan_inputs(5, 1, 24, 2, 4, 1, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(x, dt, a, b, c, d, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_vs_reference(ref, dtype):
    from repro.models.ssm import _causal_conv as r_conv
    rng = np.random.default_rng(10)
    args = (rng.standard_normal((2, 32, 48)),
            rng.standard_normal((4, 48)) * 0.5,
            rng.standard_normal(48) * 0.1)
    got = ssm._causal_conv(*(_t(v).to(getattr(torch, dtype)) for v in args))
    want = r_conv(*(jnp.asarray(v, jnp.dtype(dtype)) for v in args))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=CONV_RTOL[dtype], atol=0)


def _configs(dtype: str):
    from repro.configs import get_smoke_config as r_smoke
    kw = dict(dtype=dtype, param_dtype=dtype)
    return replace(r_smoke(ARCH), **kw), replace(get_smoke_config(ARCH), **kw)


def _layer(rcfg, cfg, seed=0):
    """(reference layer params, the port's) of one Mamba2 mixer."""
    from repro.models.common import split_tree
    from repro.models.ssm import init_mamba2
    rp, _ = split_tree(init_mamba2(jax.random.PRNGKey(seed), rcfg))
    tree = {"embed": {}, "final_norm": {},
            "layers": {"mixer": jax.tree_util.tree_map(
                lambda v: np.asarray(v)[None], rp)}}
    return rp, params_from_reference(tree, cfg, device="cpu")["layers"][0][
        "mixer"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_vs_reference(ref, dtype):
    from repro.models.ssm import mamba2_forward as r_forward
    rcfg, cfg = _configs(dtype)
    rp, params = _layer(rcfg, cfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    got = ssm.mamba2_forward(params, _t(x).to(params["w_in"].dtype), cfg)
    want = r_forward(rp, jnp.asarray(x).astype(jnp.dtype(dtype)), rcfg)
    assert got.dtype == params["w_in"].dtype
    _close(got.float(), np.asarray(want, np.float32),
           TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_vs_reference(ref, dtype):
    """Four steps with a mask that leaves some rows inactive: their conv
    window and SSM state stay as they were."""
    from repro.models.ssm import init_mamba2_cache as r_cache
    from repro.models.ssm import mamba2_decode as r_decode
    rcfg, cfg = _configs(dtype)
    rp, params = _layer(rcfg, cfg, seed=1)
    rng = np.random.default_rng(7)
    bsz = 3
    rc, cache = r_cache(rcfg, bsz), ssm.init_mamba2_cache(cfg, bsz, "cpu")
    masks = [[True, True, True], [True, False, True], [False, True, True],
             [True, True, False]]
    tol = TOL if dtype == "float32" else BF16_TOL
    for mask in masks:
        x = rng.standard_normal((bsz, 1, cfg.d_model)).astype(np.float32)
        active = np.array(mask)
        prev = {k: v.clone() for k, v in cache.items()}
        got, cache = ssm.mamba2_decode(params, _t(x).to(params["w_in"].dtype),
                                       cache, cfg,
                                       active=torch.as_tensor(active))
        want, rc = r_decode(rp, jnp.asarray(x).astype(jnp.dtype(dtype)), rc,
                            rcfg, active=jnp.asarray(active))
        _close(got.float(), np.asarray(want, np.float32), tol)
        for k in cache:
            _close(cache[k].float(), np.asarray(rc[k], np.float32), tol)
            assert torch.equal(cache[k][~torch.as_tensor(active)],
                               prev[k][~torch.as_tensor(active)])


@pytest.fixture(scope="module")
def smoke_lm(ref):
    """(reference model, its params, the port's model and params), SMOKE
    mamba2-1.3b in fp32."""
    rcfg, cfg = smoke_fp32(ARCH)
    rmodel, rparams, tree = reference_model(rcfg)
    model = build_model(cfg)
    return rmodel, rparams, model, params_from_reference(tree, cfg, "cpu")


def test_mamba_lm_vs_reference(smoke_lm):
    """Prefill logits and a run of decode steps match the reference."""
    rmodel, rparams, model, params = smoke_lm
    tokens = np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (2, 32)).astype(np.int32)
    _close(model.prefill(params, torch.as_tensor(tokens)),
           rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}), TOL)
    cache = model.init_cache(2, 32, device="cpu")
    rcache = rmodel.init_cache(2, 32)
    for t in range(6):
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(tokens[:, t:t + 1]))
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(tokens[:, t:t + 1]))
        _close(got, want, TOL)
    assert int(cache["pos"]) == int(rcache["pos"]) == 6


def test_mamba_lm_prefill_decode_parity(smoke_lm):
    """The port's prefill (two SSD chunks through the kernel's twin) and
    its token-by-token decode give the same next-token logits."""
    _, _, model, params = smoke_lm
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, (2, 32)))
    want = model.prefill(params, tokens)
    cache = model.init_cache(2, 32, device="cpu")
    for t in range(tokens.shape[1]):
        got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    torch.testing.assert_close(got, want, rtol=PARITY_TOL, atol=PARITY_TOL)


def test_param_round_trip_keeps_fp32_leaves():
    cfg = get_smoke_config(ARCH)                 # bf16 parameters
    params = build_model(cfg).init(0, device="cpu")
    back = params_from_reference(params_to_reference(params), cfg, "cpu")
    for lp, lb in zip(params["layers"], back["layers"]):
        for name, t in lp["mixer"].items():
            want = torch.float32 if name in ("A_log", "D", "dt_bias") \
                else torch.bfloat16
            assert t.dtype == lb["mixer"][name].dtype == want, name
            assert torch.equal(t, lb["mixer"][name])
        assert torch.equal(lp["norm"]["scale"], lb["norm"]["scale"])
    assert len(back["layers"]) == cfg.num_layers
    assert get_config(ARCH).num_layers == 48


def test_greedy_serving_matches_reference(smoke_lm):
    """Greedy serving of SMOKE mamba2 in lockstep with the reference engine
    (prompts stream through decode_step in both, ``prefill_chunk`` set),
    with the schedule and checks of ``tests/test_torch_serve.py``."""
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.engine import ServeEngine as RServeEngine
    rmodel, rparams, model, params = smoke_lm
    schedule = _schedule(model.cfg.vocab_size)
    rengine = RServeEngine(rmodel.cfg, RServeConfig(**SCFG), rparams)
    ref_record = _drive(rengine, schedule,
                        lambda x: np.asarray(x, np.float32))
    engine = ServeEngine(model.cfg, ServeConfig(**SCFG), params,
                         device="cpu")
    record = _drive(engine, schedule, lambda x: x.numpy().astype(np.float32),
                    commit_tokens=[r[2] for r in ref_record])
    assert_lockstep(record, ref_record)


def test_mamba_backend_streams_prompts():
    """With prefill_chunk > 0 a model without ``prefill_into_cache`` gets
    no block prefill (it used to be sent to one and raise); the engine
    streams its prompts and serves every request."""
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(0, device="cpu")
    scfg = ServeConfig(max_batch=2, max_seq_len=32, prefill_chunk=8)
    backend = DecodeBackend(cfg, scfg, params, device="cpu")
    assert not backend.supports_prefill
    assert backend.prefill_len(12) == 0
    engine = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
    rids = [engine.submit(np.arange(n) % cfg.vocab_size, 4)
            for n in (0, 3, 9, 12)]
    engine.run(max_ticks=100)
    assert len(rids) == 4 and not engine.pending
    assert engine.metrics.counter("repro_tokens_total").value == 16
    assert engine.metrics.counter("repro_prefill_tokens_total").value == 0
