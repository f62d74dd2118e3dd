"""The port's fault layer, checked links and guardrails against the
reference (``core/faults.py``, ``core/queues.py`` checked=True,
``core/guard.py``).

The reference runs per PE under ``jax.vmap(..., axis_name="pe")`` (as its
own ``tests/test_faults.py`` does); the port runs all PEs at once on the
leading PE dimension. Inputs come from a numpy seed. Health arrays,
checksums and the values of faulted streams must equal the reference's
exactly (NaN positions included): no arithmetic differs, only where the
fault lands.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import ref  # noqa: F401 (fixture)

from repro_torch.core import collective_matmul as cm
from repro_torch.core import faults, guard, queues
from repro_torch.core import ring_attention as ra
from repro_torch.core import topology as tp

N = 4
N_STEPS = 4
FAULT_HOP = 1
FAULT_DEV = 2
KINDS = [k for k in faults.KINDS if k != "none"]


def _payload(n=N, k=3):
    # strictly positive so a dropped (zeroed) payload always changes the
    # checksum — all-zero payloads are the digest's documented blind spot
    return (np.arange(n * k, dtype=np.float32).reshape(n, k) + 1.0) / 7.0


def _specs(kind, hop=FAULT_HOP, dev=FAULT_DEV, seed=3):
    from repro.core import faults as rfaults
    return (faults.FaultSpec(kind, hop=hop, device=dev, seed=seed),
            rfaults.FaultSpec(kind, hop=hop, device=dev, seed=seed))


def _ref_vmap(fn, spec, *args):
    """The reference's ``fn`` per PE under vmap, with ``spec`` armed."""
    from repro.core import faults as rfaults
    run = jax.vmap(fn, axis_name="pe")
    args = [jnp.asarray(a) for a in args]
    if spec is None:
        return run(*args)
    with rfaults.inject(spec):
        return run(*args)


def _port(fn, spec):
    if spec is None:
        return fn()
    with faults.inject(spec):
        return fn()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    """Bit-for-bit equal values (NaNs in the same places)."""
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _stream(mode, checked, spec=None, ref_spec=None, n_steps=N_STEPS):
    """(port, reference) results of the same stream."""
    from repro.core import queues as rq
    from repro.core.topology import ring as rring
    xs = _payload()
    port = _port(lambda: queues.stream(
        tp.ring("pe", N), torch.from_numpy(xs), n_steps,
        lambda s, b, t: s + b, torch.zeros(N, 3), mode, checked=checked),
        spec)
    want = _ref_vmap(lambda x, s0: rq.stream(
        rring("pe", N), x, n_steps, lambda s, b, t: s + b, s0, mode,
        checked=checked), ref_spec, xs, np.zeros((N, 3), np.float32))
    return port, want


def _stream_carry(mode, checked, spec=None, ref_spec=None):
    from repro.core import queues as rq
    from repro.core.topology import ring as rring
    static = _payload()
    port = _port(lambda: queues.stream_carry(
        tp.ring("pe", N), torch.from_numpy(static),
        torch.zeros(N, 3), N_STEPS, lambda s, c, t: c + s, mode,
        checked=checked), spec)
    want = _ref_vmap(lambda st, ca: rq.stream_carry(
        rring("pe", N), st, ca, N_STEPS, lambda s, c, t: c + s, mode,
        checked=checked), ref_spec, static, np.zeros((N, 3), np.float32))
    return port, want


# --- FaultSpec and the registry ----------------------------------------------
def test_fault_spec_validation_and_encoding(ref):
    for bad in ("none", "meteor-strike"):
        with pytest.raises(ValueError):
            faults.FaultSpec(bad)
    for kind in KINDS:
        port, want = _specs(kind, hop=2, dev=1, seed=9)
        assert port.encode() == tuple(np.asarray(want.encode()).tolist())
    assert faults.KINDS == ref.core.faults.KINDS
    assert faults.no_fault_vec() == tuple(
        np.asarray(ref.core.faults.no_fault_vec()).tolist())


def test_injected_vec_and_scope_precedence():
    assert faults.injected_vec() == (0, 0, 0, 0)
    assert faults.active_vec() is None
    spec = faults.FaultSpec("drop", hop=1)
    with faults.inject(spec):
        assert faults.injected() is spec
        assert faults.injected_vec()[0] == faults.KINDS.index("drop")
        assert faults.active_vec() == spec.encode()
        with faults.scope(faults.no_fault_vec()):   # a scope wins
            assert faults.active_vec() == (0, 0, 0, 0)
    assert faults.injected() is None and faults.active_vec() is None


def test_unarmed_and_untargeted_hops_add_no_work():
    """apply returns the very tensor it was given unless the hop is hit."""
    x = torch.arange(8.0).reshape(4, 2)
    moved = x.roll(1, 0)
    for vec in (faults.no_fault_vec(),
                faults.FaultSpec("corrupt", hop=2).encode(),
                faults.FaultSpec("stale", hop=3).encode()):
        assert faults.apply(vec, moved, x, 1) is moved
    assert faults.apply(faults.FaultSpec("corrupt", hop=1).encode(),
                        moved, x, None) is moved
    # a PE index past the ring hits nothing
    assert faults.apply(faults.FaultSpec("drop", hop=1, device=9).encode(),
                        moved, x, 1) is moved


@pytest.mark.parametrize("dtype", ["int32", "bool", "float32"])
def test_poison_leaf_matches_reference(ref, dtype):
    rng = np.random.default_rng(0)
    leaf = rng.integers(-2 ** 31, 2 ** 31, (5,), dtype=np.int64) \
        .astype(np.int32) if dtype == "int32" else \
        (rng.random(5) > 0.5 if dtype == "bool" else _payload()[0])
    for seed in (0, 7, -3):
        want = ref.core.faults._poison_leaf(jnp.asarray(leaf), seed)
        got = faults._poison_leaf(torch.from_numpy(np.asarray(leaf)), seed)
        _equal(got, want)


# --- checksum ----------------------------------------------------------------
CHECKSUM_CASES = ["float32", "bfloat16", "int32", "bool", "mixed", "wrap"]


def _checksum_payload(case, rng):
    if case in ("float32", "bfloat16"):
        x = rng.standard_normal((N, 6, 5)).astype(np.float32) * 1e3
        x[1, 0, 0], x[2, 3, 1], x[3, 0, 4] = np.nan, np.inf, -0.0
        if case == "float32":
            return (x,), (x,)
        # the same bf16 bits on both sides (the two packages round a NaN
        # to different bf16 NaNs)
        bf = np.array(jnp.asarray(x).astype(jnp.bfloat16))
        return ((bf,), (torch.from_numpy(bf.view(np.int16))
                        .view(torch.bfloat16),))
    if case == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, (N, 7), dtype=np.int64) \
            .astype(np.int32)
        return (x,), (x,)
    if case == "bool":
        x = rng.random((N, 9)) > 0.5
        return (x,), (x,)
    if case == "wrap":          # the int32 sum wraps several times
        x = np.full((N, 64), 2 ** 31 - 5, np.int32)
        return (x,), (x,)
    f = rng.standard_normal((N, 3)).astype(np.float32)
    i = rng.integers(-9, 9, (N, 4)).astype(np.int32)
    b = rng.random((N, 2)) > 0.5
    return (f, i, b), (f, i, b)


@pytest.mark.parametrize("case", CHECKSUM_CASES)
def test_checksum_equals_reference_bitwise(ref, case):
    ref_leaves, port_leaves = _checksum_payload(case, np.random.default_rng(1))
    want = jax.vmap(lambda *xs: ref.core.queues.checksum(xs))(
        *[jnp.asarray(x) for x in ref_leaves])
    got = queues.checksum(tuple(
        x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        for x in port_leaves))
    assert got.dtype == torch.int32 and got.shape == (N,)
    _equal(got, want)


def test_checksum_order_independent_and_sensitive():
    x = torch.from_numpy(_payload())
    a = queues.checksum(x)
    assert torch.equal(a, queues.checksum(x.flip(1)))   # associative digest
    bumped = x.clone()
    bumped[0, 0] += 1.0
    assert (queues.checksum(bumped) != a).tolist() == [True, False, False,
                                                       False]
    assert not torch.equal(
        queues.checksum((x, torch.arange(N * 5, dtype=torch.int32)
                         .reshape(N, 5))), a)


# --- checked links: clean parity ---------------------------------------------
@pytest.mark.parametrize("mode", queues.MODES)
def test_checked_clean_streams_bit_identical(ref, mode):
    """The sidecar is a pure observer: with no fault armed, checked and
    unchecked streams agree bit for bit, health is all-zero, and both
    equal the reference's."""
    (s_u, b_u), _ = _stream(mode, checked=False)
    (s_c, b_c, h), (rs, rb, rh) = _stream(mode, checked=True)
    assert torch.equal(s_u, s_c) and torch.equal(b_u, b_c)
    assert h.shape == (N, N_STEPS, 2) and int(h.sum()) == 0
    _equal(s_c, rs)
    _equal(b_c, rb)
    _equal(h, rh)
    (st_u, c_u), _ = _stream_carry(mode, checked=False)
    (st_c, c_c, hc), (rst, rc, rhc) = _stream_carry(mode, checked=True)
    assert torch.equal(st_u, st_c) and torch.equal(c_u, c_c)
    assert int(hc.sum()) == 0
    _equal(c_c, rc)
    _equal(hc, rhc)


# --- checked links: the detection matrix -------------------------------------
@pytest.mark.parametrize("mode", queues.MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_detection_matrix_stream(ref, mode, kind):
    """Every fault class x every link mode: the port's per-PE, per-hop
    health equals the reference's, and trips at the right (hop, PE) in the
    right column; the faulted values agree too."""
    spec, rspec = _specs(kind)
    (state, buf, health), (rs, rb, rh) = _stream(mode, True, spec, rspec)
    _equal(health, rh)
    _equal(state, rs)
    _equal(buf, rb)
    health = health.numpy()
    assert np.delete(health, FAULT_DEV, axis=0).sum() == 0
    tag, csum = health[FAULT_DEV, :, 0], health[FAULT_DEV, :, 1]
    if kind in ("corrupt", "drop"):
        assert tag.sum() == 0
        assert csum.tolist() == [int(t == FAULT_HOP) for t in range(N_STEPS)]
    elif kind == "slow":
        assert csum.sum() == 0
        assert tag.tolist() == [int(t == FAULT_HOP) for t in range(N_STEPS)]
    else:                                            # stale: persistent
        assert csum.sum() == 0
        assert tag.tolist() == [int(t >= FAULT_HOP) for t in range(N_STEPS)]


@pytest.mark.parametrize("mode", queues.MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_detection_matrix_stream_carry(ref, mode, kind):
    """stream_carry rides the sidecar on both queue sets, so a faulted hop
    reports 2 in its column; health and values equal the reference's."""
    spec, rspec = _specs(kind, seed=5)
    (static, carry, health), (rst, rc, rh) = _stream_carry(mode, True, spec,
                                                           rspec)
    _equal(health, rh)
    _equal(static, rst)
    _equal(carry, rc)
    health = health.numpy()
    assert np.delete(health, FAULT_DEV, axis=0).sum() == 0
    col = 1 if kind in ("corrupt", "drop") else 0
    assert health[FAULT_DEV, FAULT_HOP, col] == 2
    assert health[FAULT_DEV, :, 1 - col].sum() == 0


@pytest.mark.parametrize("mode", queues.MODES)
def test_hop_zero_stall_detected(ref, mode):
    """Stuck from the very first hop: sequence numbers agree (both say
    t=0), only the sender-id stamp can tell — and does."""
    spec, rspec = _specs("stale", hop=0)
    (_, _, health), (_, _, rh) = _stream(mode, True, spec, rspec)
    _equal(health, rh)
    assert health[FAULT_DEV, :, 0].tolist() == [1] * N_STEPS
    assert int(health[FAULT_DEV, :, 1].sum()) == 0


def test_checked_hop_needs_its_index():
    with pytest.raises(ValueError, match="hop index"):
        queues.hop(tp.ring("pe", N), torch.ones(N, 2), checked=True)


# --- unchecked links fail silently (why the sidecar exists) ------------------
@pytest.mark.parametrize("kind", KINDS)
def test_unchecked_faults_equal_reference(ref, kind):
    """Unchecked, every kind changes the stream's values exactly as in the
    reference: corruption poisons the faulted PE silently, a drop zeroes
    one pop (finite, but different)."""
    spec, rspec = _specs(kind, hop=0 if kind == "drop" else FAULT_HOP,
                         dev=0 if kind == "drop" else FAULT_DEV)
    (state, buf), (rs, rb) = _stream("qlr", False, spec, rspec)
    _equal(state, rs)
    _equal(buf, rb)
    (clean, _), _ = _stream("qlr", False)
    if kind == "corrupt":
        assert torch.isnan(state[FAULT_DEV]).any()
    elif kind == "drop":
        assert torch.isfinite(state).all() and not torch.equal(state, clean)


def _ring_op_cases():
    """(name, port fn, reference fn per PE, numpy inputs) of the ring ops
    that carry hop indices, on a ring of 4."""
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    b, sq, h, kvh, hd = 2, 3, 4, 2, 8
    q, k, v = r(N, b, sq, h, hd), r(N, b, sq, kvh, hd), r(N, b, sq, kvh, hd)
    bsz, s_loc = N * b, 3
    dq = r(N, b, 1, h, hd)
    kc, vc = r(N, bsz, s_loc, kvh, hd), r(N, bsz, s_loc, kvh, hd)
    pos = rng.integers(0, N * s_loc, bsz).astype(np.int32)
    x, w = r(N, 2, 2 * N, 6), r(N, 6, 5)

    def cache(a):
        return torch.from_numpy(a).transpose(0, 1).reshape(
            bsz, N * s_loc, kvh, hd)

    return {
        "ring_attention": (
            lambda topo: ra.ring_attention(
                *map(torch.from_numpy, (q, k, v)), topo, "qlr"),
            lambda rra, rtopo: (lambda a, c, d: rra.ring_attention(
                a, c, d, rtopo, "qlr")), (q, k, v)),
        "ring_decode": (
            lambda topo: ra.ring_decode_attention(
                torch.from_numpy(dq), cache(kc), cache(vc),
                torch.from_numpy(pos), topo, "qlr"),
            lambda rra, rtopo: (lambda a, c, d, p: rra.ring_decode_attention(
                a, c, d, p, rtopo, "qlr")),
            (dq, kc, vc, np.broadcast_to(pos, (N, bsz)))),
        "ring_matmul_rs": (
            lambda topo: cm.ring_matmul_rs(torch.from_numpy(x),
                                           torch.from_numpy(w), topo, "xqueue"),
            lambda rcm, rtopo: (lambda a, c: rcm.ring_matmul_rs(
                a, c, rtopo, "xqueue")), (x, w)),
    }


@pytest.mark.parametrize("op", ["ring_attention", "ring_decode",
                                "ring_matmul_rs"])
@pytest.mark.parametrize("kind", ["corrupt", "stale"])
def test_ring_ops_faulted_like_reference(ref, op, kind):
    """The ring ops pass the reference's hop indices, so one FaultSpec hits
    the same (hop, PE) in both packages: the faulted outputs agree."""
    from repro.core import collective_matmul as rcm
    from repro.core import ring_attention as rra
    from repro.core.topology import ring as rring
    port_fn, ref_fn, args = _ring_op_cases()[op]
    spec, rspec = _specs(kind)
    got = _port(lambda: port_fn(tp.ring("pe", N)), spec)
    want = _ref_vmap(ref_fn(rcm if op == "ring_matmul_rs" else rra,
                            rring("pe", N)), rspec, *args)
    clean = port_fn(tp.ring("pe", N))
    assert not torch.equal(got, clean)              # the fault did land
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)           # NaNs in the same places


# --- guardrails --------------------------------------------------------------
def test_all_finite_and_row_finite(ref):
    from repro.core import guard as rguard
    good = {"a": torch.ones(2, 3), "n": torch.arange(4)}
    assert bool(guard.all_finite(good))
    bad_a = torch.ones(2, 3)
    bad_a[1, 2] = float("nan")
    assert not bool(guard.all_finite({"a": bad_a}))
    logits = np.zeros((3, 4), np.float32)
    logits[1, 0] = np.inf
    want = rguard.row_finite(logits).tolist()
    assert guard.row_finite(torch.from_numpy(logits)).tolist() == want
    assert guard.row_finite(logits).tolist() == want == [True, False, True]


def test_check_finite_names_the_leaf(ref):
    from repro.core import guard as rguard
    tree = {"ok": np.ones(3, np.float32), "bad": np.full(4, np.inf,
                                                         np.float32)}
    guard.check_finite({"ok": torch.ones(3)}, "clean")   # no raise
    with pytest.raises(guard.NonFiniteError) as got:
        guard.check_finite({k: torch.from_numpy(v) for k, v in tree.items()},
                           "ring output")
    with pytest.raises(rguard.NonFiniteError) as want:
        rguard.check_finite(tree, "ring output")
    assert str(got.value) == str(want.value)
    assert "bad" in str(got.value) and "4/4" in str(got.value)
