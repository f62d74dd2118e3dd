"""The port's 2-D grid schedules against the reference: torus2d and
cannon_grid on 2x2 and 2x4 folds (and 4x4 for the tables).

The reference runs per PE under ``jax.vmap(..., axis_name=...)``, as
``tests/test_torch_ring.py`` runs it; the port runs all PEs at once on
the leading PE dimension. Inputs come from a numpy seed; values agree to
1e-5 in fp32. Schedule tables, checked-link health, fault positions and
telemetry totals must equal the reference's exactly.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_faults import _equal, _payload, _port, _ref_vmap, _specs
from test_torch_reference import ref, to_torch  # noqa: F401 (fixture)
from test_torch_telemetry import _port_totals, _ref_totals

from repro_torch.core import collective_matmul as cm
from repro_torch.core import queues
from repro_torch.core import ring_attention as ra
from repro_torch.core import topology as tp

TOL = 1e-5
MODES = ("baseline", "sw", "xqueue", "qlr")
GRIDS = [pytest.param(n, name, id=f"{name}-{n}")
         for n in (4, 8) for name in ("torus2d", "cannon_grid")]


def _grids(n, name, axis="model"):
    from repro.core import topology as rtp
    return tp.resolve(name, axis, n), rtp.resolve(name, axis, n)


def _vmap(fn, *args, axis="model"):
    return jax.vmap(fn, axis_name=axis)(*map(jnp.asarray, args))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _perms(sched):
    return None if sched is None else (sched.name, sched.size, sched.perm)


# ---------------------------------------------------------------------------
# schedules and tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,name", GRIDS + [
    pytest.param(16, "torus2d", id="torus2d-16"),
    pytest.param(16, "cannon_grid", id="cannon_grid-16")])
def test_grid_tables_match_reference(ref, n, name):
    from repro.core import topology as rtp
    port, want = _grids(n, name)
    assert (port.name, port.rows, port.cols, port.size) == \
        (want.name, want.rows, want.cols, want.size)
    assert [_perms(h) for h in port.hops] == [_perms(h) for h in want.hops]
    for part in ("skew", "row", "col"):
        assert _perms(getattr(port, part)) == _perms(getattr(want, part))
    assert [_perms(h) for h in tp.hop_topos(port)] == \
        [_perms(h) for h in rtp.hop_topos(want)]
    np.testing.assert_array_equal(tp.source_table(port),
                                  rtp.source_table(want))
    np.testing.assert_array_equal(tp.dest_table(port), rtp.dest_table(want))
    assert not tp.is_cycle(port) and not rtp.is_cycle(want)
    # every PE sees every shard exactly once
    assert all(sorted(r) == list(range(n)) for r in tp.source_table(port))


@pytest.mark.parametrize("n", [2, 4, 6, 8, 9, 12, 16])
@pytest.mark.parametrize("name", ["ring", "snake_fold", "torus2d",
                                  "cannon_grid", "torus2d:2x4",
                                  "cannon_grid:4x2", "bogus"])
def test_resolve_safe_matches_reference(ref, n, name):
    """The fallback to the +1 ring where a grid does not fold or close, a
    cycle-only caller, or an unknown name; a grid that applies is kept."""
    from repro.core import topology as rtp
    for cycle_only in (False, True):
        got = tp.resolve_safe(name, "model", n, cycle_only=cycle_only)
        want = rtp.resolve_safe(name, "model", n, cycle_only=cycle_only)
        assert type(got).__name__ == type(want).__name__
        assert got.name == want.name
        assert [_perms(h) for h in tp.hop_topos(got)] == \
            [_perms(h) for h in rtp.hop_topos(want)]


@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 3), (2, 4), (4, 4)])
@pytest.mark.parametrize("which", ["rows", "cols"])
def test_cannon_skew_matches_reference(ref, rows, cols, which):
    from repro.core import topology as rtp
    assert _perms(tp.cannon_skew("pe", rows, cols, which=which)) == \
        _perms(rtp.cannon_skew("pe", rows, cols, which=which))


# ---------------------------------------------------------------------------
# grid streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,name", GRIDS)
def test_grid_stream_modes_identical_and_match_reference(ref, n, name):
    """Every mode gives the reference's state and buffer bit for bit;
    torus2d brings the buffer home after n hops."""
    from repro.core import queues as rq
    port, want_sched = _grids(n, name)
    xs = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    states = {}
    for mode in queues.MODES:
        state, buf = queues.stream(port, torch.from_numpy(xs), n,
                                   lambda s, b, t: s * 3 + (t + 1.0) * b,
                                   torch.zeros(n, 3), mode)
        rs, rb = _vmap(lambda x, s0: rq.stream(
            want_sched, x, n, lambda s, b, t: s * 3 + (t + 1.0) * b, s0,
            mode), xs, np.zeros((n, 3), np.float32))
        _equal(state, rs)
        _equal(buf, rb)
        states[mode] = state
        if name == "torus2d":
            assert torch.equal(buf, torch.from_numpy(xs))
    assert torch.equal(states["sw"], states["qlr"])
    assert torch.equal(states["xqueue"], states["qlr"])
    with pytest.raises(ValueError):
        queues.stream(port, torch.from_numpy(xs), n - 1,
                      lambda s, b, t: s, torch.zeros(n, 3))


@pytest.mark.parametrize("mode", queues.MODES)
@pytest.mark.parametrize("name", ["torus2d", "cannon_grid"])
def test_checked_grid_stream_clean(ref, mode, name):
    """Checked and unchecked grid streams agree; health [n, n, 2] is zero
    and equals the reference's."""
    from repro.core import queues as rq
    port, want = _grids(4, name, axis="pe")
    xs = _payload()
    s_u, b_u = queues.stream(port, torch.from_numpy(xs), 4,
                             lambda s, b, t: s + b, torch.zeros(4, 3), mode)
    s_c, b_c, h = queues.stream(port, torch.from_numpy(xs), 4,
                                lambda s, b, t: s + b, torch.zeros(4, 3),
                                mode, checked=True)
    rs, rb, rh = _ref_vmap(lambda x, s0: rq.stream(
        want, x, 4, lambda s, b, t: s + b, s0, mode, checked=True), None,
        xs, np.zeros((4, 3), np.float32))
    assert torch.equal(s_u, s_c) and torch.equal(b_u, b_c)
    assert h.shape == (4, 4, 2) and int(h.sum()) == 0
    _equal(h, rh)
    _equal(s_c, rs)
    _equal(b_c, rb)


@pytest.mark.parametrize("mode", queues.MODES)
@pytest.mark.parametrize("kind", ["corrupt", "drop", "stale", "slow"])
def test_checked_grid_fault_at_the_skew_hop(ref, mode, kind):
    """A fault at the skew hop (sequence number n_steps) is caught, in hop
    0's row of the health: equal to the reference's, values included."""
    from repro.core import queues as rq
    port, want = _grids(4, "cannon_grid", axis="pe")
    spec, rspec = _specs(kind, hop=4, dev=2)
    xs = _payload()
    state, buf, health = _port(lambda: queues.stream(
        port, torch.from_numpy(xs), 4, lambda s, b, t: s + b,
        torch.zeros(4, 3), mode, checked=True), spec)
    rs, rb, rh = _ref_vmap(lambda x, s0: rq.stream(
        want, x, 4, lambda s, b, t: s + b, s0, mode, checked=True), rspec,
        xs, np.zeros((4, 3), np.float32))
    _equal(health, rh)
    _equal(state, rs)
    _equal(buf, rb)
    h = health.numpy()
    assert h[2, 0].sum() >= 1, h
    assert np.delete(h, 2, axis=0).sum() == 0


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("mode", queues.MODES)
@pytest.mark.parametrize("name", ["torus2d", "cannon_grid"])
def test_grid_stream_telemetry_equals_reference(ref, name, mode, checked):
    """n hops plus the skew hop, each recorded as the reference records
    it; a fault at the skew hop shows in the error totals."""
    from repro.core import queues as rq
    port, want = _grids(4, name, axis="pe")
    spec, rspec = (_specs("corrupt", hop=4, dev=1) if checked
                   else (None, None))
    xs = _payload()
    _, got = _port_totals(lambda: queues.stream(
        port, torch.from_numpy(xs), 4, lambda s, b, t: s + b,
        torch.zeros(4, 3), mode, checked=checked), spec)
    _, totals = _ref_totals(lambda x, s0: rq.stream(
        want, x, 4, lambda s, b, t: s + b, s0, mode, checked=checked),
        xs, np.zeros((4, 3), np.float32), spec=rspec)
    assert got == totals
    hops = 4 + (name == "cannon_grid")
    assert got["pushes"] == 4 * hops
    if checked and name == "cannon_grid":
        assert got["csum_errors"] == got["faulty_hops"] == 1


def test_stream_carry_and_decode_refuse_grids():
    grid = tp.resolve("torus2d", "model", 4)
    with pytest.raises(TypeError):
        queues.stream_carry(grid, torch.zeros(4, 2), torch.zeros(4, 2), 4,
                            lambda s, c, t: c)
    q = torch.zeros(4, 1, 1, 2, 4)
    cache = torch.zeros(4, 8, 1, 4)
    with pytest.raises(TypeError):
        ra.ring_decode_attention(q, cache, cache, torch.zeros(4, dtype=int),
                                 grid)


# ---------------------------------------------------------------------------
# the ring ops on grid schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,name", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_ring_ag_matmul_per_pe(ref, n, name, mode):
    from repro.core import collective_matmul as rcm
    port, want_sched = _grids(n, name)
    rng = np.random.default_rng(20 + n)
    x = _rand(rng, n, 2, 3, 8)
    w1, w2 = _rand(rng, n, 8, 5), _rand(rng, n, 8, 6)
    want = _vmap(lambda a, c, d: rcm.ring_ag_matmul(a, [c, d], want_sched,
                                                    mode), x, w1, w2)
    got = cm.ring_ag_matmul(to_torch(x), [to_torch(w1), to_torch(w2)],
                            port, mode)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("n,name", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_ring_matmul_rs_per_pe(ref, n, name, mode):
    from repro.core import collective_matmul as rcm
    port, want_sched = _grids(n, name)
    rng = np.random.default_rng(30 + n)
    x, w = _rand(rng, n, 2, 2 * n, 6), _rand(rng, n, 6, 5)
    want = _vmap(lambda a, c: rcm.ring_matmul_rs(a, c, want_sched, mode),
                 x, w)
    _close(cm.ring_matmul_rs(to_torch(x), to_torch(w), port, mode), want)


@pytest.mark.parametrize("n,name", GRIDS)
@pytest.mark.parametrize("mode", MODES)
def test_ring_attention_per_pe(ref, n, name, mode):
    from repro.core import ring_attention as rra
    port, want_sched = _grids(n, name)
    rng = np.random.default_rng(n)
    b, sq, h, kvh, hd = 2, 3, 4, 2, 8
    q = _rand(rng, n, b, sq, h, hd)
    k, v = _rand(rng, n, b, sq, kvh, hd), _rand(rng, n, b, sq, kvh, hd)
    for window in (0, 4):
        want = _vmap(lambda a, c, d: rra.ring_attention(
            a, c, d, want_sched, mode, causal=True, window=window), q, k, v)
        got = ra.ring_attention(to_torch(q), to_torch(k), to_torch(v),
                                port, mode, causal=True, window=window)
        _close(got, want)


@pytest.mark.parametrize("mode", ["sw", "xqueue", "qlr"])
def test_systolic_wrappers_on_grids_equal_ring(mode):
    """The global wrappers on a grid give the +1 ring's values (2x4)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, generator=g)
    wg, wu = torch.randn(16, 24, generator=g), torch.randn(16, 24,
                                                           generator=g)
    wd = torch.randn(24, 16, generator=g)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k = torch.randn(2, 16, 2, 8, generator=g)
    want_ffn = cm.systolic_ffn(x, wg, wu, wd, 8, mode)
    want_attn = ra.systolic_ring_attention(q, k, k, 8, mode, window=5)
    for name in ("torus2d", "cannon_grid"):
        grid = tp.resolve(name, "model", 8)
        torch.testing.assert_close(
            cm.systolic_ffn(x, wg, wu, wd, 8, mode, topo=grid), want_ffn)
        torch.testing.assert_close(ra.systolic_ring_attention(
            q, k, k, 8, mode, window=5, topo=grid), want_attn)


# ---------------------------------------------------------------------------
# Cannon's one-hop grid skew
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("mode", MODES)
def test_cannon_grid_skew_equals_masked(n, mode):
    g = torch.Generator().manual_seed(n)
    a = torch.randn(4 * n, 6 * n, generator=g)
    b = torch.randn(6 * n, 2 * n, generator=g)
    masked = cm.systolic_cannon(a, b, n, mode)
    assert torch.equal(cm.systolic_cannon(a, b, n, mode, skew="grid"),
                       masked)
    torch.testing.assert_close(masked, a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["sw", "xqueue", "qlr"])
def test_cannon_grid_skew_vs_reference_and_its_hops(ref, mode):
    """On a 2x2 grid: the reference's ``cannon_matmul(skew="grid")`` per
    PE; 2 skew hops (sequence numbers n-1 and n) and 2(n-1) main hops,
    against 4(n-1) for the masked skew, in the telemetry."""
    from repro.core import collective_matmul as rcm
    n = 2
    left, up = cm.cannon_topologies("pe", n, n)
    from repro.core.topology import Topology as RTopology
    rleft = RTopology(left.name, "pe", 4, left.perm)
    rup = RTopology(up.name, "pe", 4, up.perm)
    rng = np.random.default_rng(7)
    a, b = _rand(rng, 4, 3, 5), _rand(rng, 4, 5, 2)
    want = _vmap(lambda x, y: rcm.cannon_matmul(
        x, y, rleft, rup, n, n, mode, skew="grid"), a, b, axis="pe")
    got, counts = _port_totals(lambda: cm.cannon_matmul(
        to_torch(a), to_torch(b), left, up, n, n, mode, skew="grid"))
    _close(got, want)
    _, masked = _port_totals(lambda: cm.cannon_matmul(
        to_torch(a), to_torch(b), left, up, n, n, mode))
    # a hop of one operand: 4 PEs push and pop one tile each
    assert counts["pushes"] == counts["pops"] == (2 + 2 * (n - 1)) * 4
    assert masked["pushes"] == 4 * (n - 1) * 4
    with pytest.raises(ValueError):
        cm.cannon_matmul(to_torch(a), to_torch(b), left, up, n, n, mode,
                         skew="bogus")
