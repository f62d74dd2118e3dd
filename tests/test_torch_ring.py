"""The port's ring layer against the reference, per PE, in every mode.

The reference runs its shard_map-local ring ops under
``jax.vmap(..., axis_name="model")`` (as ``tests/test_property_systolic.py``
does): each vmap lane is one PE. The port runs all PEs at once on a leading
PE dimension. Inputs come from a numpy seed; values agree to 1e-5 in fp32.
The port's ring ops call the kernel wrappers, which take their plain
twins for these CPU tensors.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import ref, to_torch  # noqa: F401 (fixture)

from repro_torch.core import collective_matmul as cm
from repro_torch.core import queues
from repro_torch.core import ring_attention as ra
from repro_torch.core import topology as tp

TOL = 1e-5
MODES = ("baseline", "sw", "xqueue", "qlr")
TOPOLOGIES = [pytest.param(2, "ring", id="ring2"),
              pytest.param(4, "ring", id="ring4"),
              pytest.param(4, "snake_fold", id="snake2x2")]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _topos(n, name):
    from repro.core import topology as rtp
    return tp.resolve(name, "model", n), rtp.resolve(name, "model", n)


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name="model")(*map(jnp.asarray, args))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n,name", TOPOLOGIES)
def test_topology_tables_match_reference(ref, n, name):
    port, rtopo = _topos(n, name)
    from repro.core import topology as rtp
    assert port.perm == rtopo.perm
    np.testing.assert_array_equal(tp.source_table(port),
                                  rtp.source_table(rtopo))
    np.testing.assert_array_equal(tp.dest_table(port), rtp.dest_table(rtopo))
    assert tp.is_cycle(port) == rtp.is_cycle(rtopo)
    for cyc in (False, True):
        for nm in ("ring", "snake_fold", "torus2d", "bogus"):
            got = tp.resolve_safe(nm, "model", n, cycle_only=cyc)
            want = rtp.resolve_safe(nm, "model", n, cycle_only=cyc)
            # a grid that folds is kept for a full-coverage caller (ported)
            assert got.name == want.name
            assert [h.perm for h in tp.hop_topos(got)] == \
                [h.perm for h in rtp.hop_topos(want)]


@pytest.mark.parametrize("size,k", [(8, 1), (8, 2), (8, 4), (6, 3),
                                    (4, 4)])
def test_chains_table_matches_reference(ref, size, k):
    from repro.core import topology as rtp
    port, want = tp.chains("model", size, k), rtp.chains("model", size, k)
    assert (port.name, port.size, port.perm) == \
        (want.name, want.size, want.perm)


@pytest.mark.parametrize("rows,cols", [(2, 2), (4, 4), (2, 3)])
@pytest.mark.parametrize("direction", ["right", "left", "down", "up"])
def test_torus_shift_table_matches_reference(ref, rows, cols, direction):
    from repro.core import topology as rtp
    port = tp.torus_shift("model", rows, cols, direction=direction)
    want = rtp.torus_shift("model", rows, cols, direction=direction)
    assert (port.name, port.size, port.perm) == \
        (want.name, want.size, want.perm)
    assert tp.is_cycle(port) == rtp.is_cycle(want)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_stream_modes_identical_and_buffer_returns_home(n):
    topo = tp.ring("model", n)
    g = torch.Generator().manual_seed(n)
    xs = torch.randint(-8, 8, (n, 3), generator=g).float()
    states = {}
    for mode in queues.MODES:
        state, buf = queues.stream(
            topo, xs, n, lambda s, b, t: s + (t + 1.0) * b,
            torch.zeros(n, 3), mode)
        torch.testing.assert_close(buf, xs, rtol=0, atol=0)
        states[mode] = state
    assert torch.equal(states["sw"], states["xqueue"])
    assert torch.equal(states["xqueue"], states["qlr"])


def test_hop_matches_reference_ppermute(ref):
    from repro.core import queues as rq
    port, rtopo = _topos(4, "snake_fold")
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for mode in queues.MODES:
        want = _vmap(lambda v: rq.hop(rtopo, v, mode), x)
        got = queues.hop(port, (to_torch(x), to_torch(x) * 2), mode)
        _close(got[0], want)
        _close(got[1], 2 * want)


@pytest.mark.parametrize("n,name", TOPOLOGIES)
@pytest.mark.parametrize("mode", MODES)
def test_ring_attention_per_pe(ref, n, name, mode):
    from repro.core import ring_attention as rra
    port, rtopo = _topos(n, name)
    rng = np.random.default_rng(n)
    b, sq, h, kvh, hd = 2, 3, 4, 2, 8
    q = _rand(rng, n, b, sq, h, hd)
    k, v = _rand(rng, n, b, sq, kvh, hd), _rand(rng, n, b, sq, kvh, hd)
    for window in (0, 4):
        want = _vmap(lambda a, c, d: rra.ring_attention(
            a, c, d, rtopo, mode, causal=True, window=window), q, k, v)
        got = ra.ring_attention(to_torch(q), to_torch(k), to_torch(v),
                                port, mode, causal=True, window=window)
        _close(got, want)


@pytest.mark.parametrize("n,name", TOPOLOGIES)
@pytest.mark.parametrize("mode", MODES)
def test_ring_decode_attention_per_pe(ref, n, name, mode):
    from repro.core import ring_attention as rra
    port, rtopo = _topos(n, name)
    rng = np.random.default_rng(10 + n)
    b_loc, s_loc, h, kvh, hd = 2, 3, 4, 2, 8
    bsz = n * b_loc
    q = _rand(rng, n, b_loc, 1, h, hd)
    k_all, v_all = _rand(rng, n, bsz, s_loc, kvh, hd), \
        _rand(rng, n, bsz, s_loc, kvh, hd)
    pos = rng.integers(0, n * s_loc, bsz).astype(np.int32)
    pos[0] = 0                                    # attends to one slot only
    want = _vmap(lambda a, c, d, p: rra.ring_decode_attention(
        a, c, d, p, rtopo, mode), q, k_all, v_all,
        np.broadcast_to(pos, (n, bsz)))

    def cache(x):                 # per-PE slot shards -> global [B, S, ...]
        return to_torch(x).transpose(0, 1).reshape(bsz, n * s_loc, kvh, hd)

    got = ra.ring_decode_attention(
        to_torch(q), cache(k_all), cache(v_all), torch.tensor(pos), port,
        mode)
    _close(got, want)


@pytest.mark.parametrize("n,name", TOPOLOGIES)
@pytest.mark.parametrize("mode", MODES)
def test_ring_ag_matmul_per_pe(ref, n, name, mode):
    from repro.core import collective_matmul as rcm
    port, rtopo = _topos(n, name)
    rng = np.random.default_rng(20 + n)
    x = _rand(rng, n, 2, 3, 8)
    w1, w2 = _rand(rng, n, 8, 5), _rand(rng, n, 8, 6)
    want = _vmap(lambda a, c, d: rcm.ring_ag_matmul(a, [c, d], rtopo, mode),
                 x, w1, w2)
    got = cm.ring_ag_matmul(to_torch(x), [to_torch(w1), to_torch(w2)],
                            port, mode)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("n,name", TOPOLOGIES)
@pytest.mark.parametrize("mode", MODES)
def test_ring_matmul_rs_per_pe(ref, n, name, mode):
    from repro.core import collective_matmul as rcm
    port, rtopo = _topos(n, name)
    rng = np.random.default_rng(30 + n)
    x, w = _rand(rng, n, 2, 2 * n, 6), _rand(rng, n, 6, 5)
    want = _vmap(lambda a, c: rcm.ring_matmul_rs(a, c, rtopo, mode), x, w)
    got = cm.ring_matmul_rs(to_torch(x), to_torch(w), port, mode)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sw", "xqueue", "qlr"])
def test_systolic_wrappers_equal_dense(mode):
    """The global wrappers split and join correctly: they equal the plain
    dense computation (ring size 2, all modes)."""
    g = torch.Generator().manual_seed(0)
    b, s, d, h, kvh, hd, f = 2, 8, 16, 4, 2, 4, 12
    x = torch.randn(b, s, d, generator=g)
    wq, wk, wv = (torch.randn(d, hh, hd, generator=g) for hh in (h, kvh, kvh))
    got = cm.systolic_qkv(x, wq, wk, wv, 2, mode)
    for y, w in zip(got, (wq, wk, wv)):
        torch.testing.assert_close(y, torch.einsum("bsd,dhk->bshk", x, w))
    o = torch.randn(b, s, h, hd, generator=g)
    wo = torch.randn(h, hd, d, generator=g)
    torch.testing.assert_close(
        cm.systolic_out_proj(o, wo, 2, mode),
        torch.einsum("bshk,hkd->bsd", o, wo))
    wg, wu, wd = torch.randn(d, f, generator=g), torch.randn(d, f, generator=g), \
        torch.randn(f, d, generator=g)
    want = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    torch.testing.assert_close(
        cm.systolic_ffn(x, wg, wu, wd, 2, mode), want)
