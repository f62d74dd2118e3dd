"""The port's link telemetry (``obs/linkstats.py``) and the paper-model
accounting (``obs/utilization.py``, ``core/energy.py``) against the
reference.

The reference records per PE: each PE, a ``jax.vmap(..., axis_name=...)``
lane here as in its own ``tests/test_obs.py``, opens an inner scope, ships
its counters out as an extra output and ``device_sum`` adds them up. The
port records every PE at once, so its ``as_dict()`` must equal those
totals exactly, for the stream drivers and for the ring ops in all four
modes (the baselines' multicast bytes included), and for a serving backend
as a whole: the reference's ``RingShardedBackend`` needs a device mesh,
so it runs in a subprocess (this file run as a script) on fake CPU
devices. Inputs come from a numpy seed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import (  # noqa: F401 (fixture)
    SRC,
    ref,
    reference_model,
    smoke_fp32,
    to_torch,
)

from repro_torch.core import collective_matmul as cm
from repro_torch.core import energy, faults, halo, queues
from repro_torch.core import ring_attention as ra
from repro_torch.core import topology as tp
from repro_torch.configs import ServeConfig
from repro_torch.models import params_from_reference
from repro_torch.obs import linkstats, utilization
from repro_torch.serve.sharded_cache import RingShardedBackend

N = 4
N_STEPS = 4
MODES = ("baseline", "sw", "xqueue", "qlr")


def _payload(n=N, k=3):
    return (np.arange(n * k, dtype=np.float32).reshape(n, k) + 1.0) / 7.0


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ref_totals(fn, *args, spec=None, axis="pe", in_axes=0):
    """(outputs, device-summed LinkStats dict) of the reference's ``fn``
    per PE: the republish pattern of the reference's systolic wrappers."""
    from repro.core import faults as rfaults
    from repro.obs import linkstats as rls

    def device_fn(*a):
        with rls.collect(1) as sc:
            out = fn(*a)
        return out, rls.expand(sc.stats)

    run = jax.vmap(device_fn, in_axes=in_axes, axis_name=axis)
    args = [jnp.asarray(a) for a in args]
    if spec is None:
        out, stats = run(*args)
    else:
        with rfaults.inject(spec):
            out, stats = run(*args)
    flat = jax.tree_util.tree_map(lambda l: l.reshape(-1), stats)
    return out, rls.device_sum(flat).as_dict()


def _port_totals(fn, spec=None):
    with linkstats.collect() as sc:
        if spec is None:
            out = fn()
        else:
            with faults.inject(spec):
                out = fn()
    return out, sc.stats.as_dict()


def _stream_pair(mode, checked=False, kind=None):
    from repro.core import faults as rfaults
    from repro.core import queues as rq
    from repro.core.topology import ring as rring
    xs = _payload()
    spec = rspec = None
    if kind is not None:
        spec = faults.FaultSpec(kind, hop=1, device=2)
        rspec = rfaults.FaultSpec(kind, hop=1, device=2)
    _, got = _port_totals(lambda: queues.stream(
        tp.ring("pe", N), torch.from_numpy(xs), N_STEPS,
        lambda s, b, t: s + b, torch.zeros(N, 3), mode, checked=checked),
        spec)
    _, want = _ref_totals(lambda x, s0: rq.stream(
        rring("pe", N), x, N_STEPS, lambda s, b, t: s + b, s0, mode,
        checked=checked), xs, np.zeros((N, 3), np.float32), spec=rspec)
    return got, want


# --- the stream drivers -------------------------------------------------------
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("mode", queues.MODES)
def test_stream_counts_equal_reference(ref, mode, checked):
    got, want = _stream_pair(mode, checked)
    assert got == want
    assert got["pushes"] == got["pops"] == N * N_STEPS
    assert got["payload_bytes"] == N * N_STEPS * 3 * 4   # sidecar excluded
    assert got["mcast_bytes"] == got["tag_errors"] == got["csum_errors"] == 0


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("mode", queues.MODES)
def test_stream_carry_counts_equal_reference(ref, mode, checked):
    from repro.core import queues as rq
    from repro.core.topology import ring as rring
    static = _payload()
    carry = (np.zeros((N, 2), np.float32), np.zeros((N, 3), np.float32))
    _, got = _port_totals(lambda: queues.stream_carry(
        tp.ring("pe", N), torch.from_numpy(static),
        tuple(map(torch.from_numpy, carry)), N_STEPS,
        lambda s, c, t: (c[0] + 1, c[1] + s), mode, checked=checked))
    _, want = _ref_totals(lambda st, c0, c1: rq.stream_carry(
        rring("pe", N), st, (c0, c1), N_STEPS,
        lambda s, c, t: (c[0] + 1, c[1] + s), mode, checked=checked),
        static, *carry)
    assert got == want
    assert got["pushes"] == N * N_STEPS * 3                 # three queues


@pytest.mark.parametrize("kind", ["corrupt", "drop", "stale", "slow"])
def test_faults_show_in_error_totals(ref, kind):
    """A mid-stream fault surfaces in the checked-link error totals as in
    the reference; the traffic counters are unaffected."""
    clean, _ = _stream_pair("qlr", checked=True)
    got, want = _stream_pair("qlr", checked=True, kind=kind)
    assert got == want
    col = "csum_errors" if kind in ("corrupt", "drop") else "tag_errors"
    other = "tag_errors" if col == "csum_errors" else "csum_errors"
    assert got[col] >= 1 and got["faulty_hops"] >= 1 and got[other] == 0
    assert (got["pushes"], got["payload_bytes"]) == \
        (clean["pushes"], clean["payload_bytes"])


def test_counts_mode_invariant():
    base = _stream_pair("sw")[0]
    for mode in ("xqueue", "qlr"):
        assert _stream_pair(mode)[0] == base


# --- the ring ops, all four modes --------------------------------------------
def _ring_cases(n):
    rng = np.random.default_rng(n)
    b, sq, h, kvh, hd = 2, 3, 4, 2, 8
    bsz, s_loc = n * b, 3
    pos = rng.integers(0, n * s_loc, bsz).astype(np.int32)

    def cache(a):
        return to_torch(a).transpose(0, 1).reshape(bsz, n * s_loc, kvh, hd)

    return {
        "ring_attention": (
            (_rand(rng, n, b, sq, h, hd), _rand(rng, n, b, sq, kvh, hd),
             _rand(rng, n, b, sq, kvh, hd)),
            lambda args, topo, mode: ra.ring_attention(
                *map(to_torch, args), topo, mode),
            lambda r, rtopo, mode: lambda a, c, d: r.ring_attention.
            ring_attention(a, c, d, rtopo, mode)),
        "ring_decode": (
            (_rand(rng, n, b, 1, h, hd), _rand(rng, n, bsz, s_loc, kvh, hd),
             _rand(rng, n, bsz, s_loc, kvh, hd),
             np.broadcast_to(pos, (n, bsz))),
            lambda args, topo, mode: ra.ring_decode_attention(
                to_torch(args[0]), cache(args[1]), cache(args[2]),
                torch.from_numpy(pos), topo, mode),
            lambda r, rtopo, mode: lambda a, c, d, p: r.ring_attention.
            ring_decode_attention(a, c, d, p, rtopo, mode)),
        "ring_ag_matmul": (
            (_rand(rng, n, 2, 3, 8), _rand(rng, n, 8, 5), _rand(rng, n, 8, 6)),
            lambda args, topo, mode: cm.ring_ag_matmul(
                to_torch(args[0]), [to_torch(args[1]), to_torch(args[2])],
                topo, mode),
            lambda r, rtopo, mode: lambda a, c, d: r.collective_matmul.
            ring_ag_matmul(a, [c, d], rtopo, mode)),
        "ring_matmul_rs": (
            (_rand(rng, n, 2, 2 * n, 6), _rand(rng, n, 6, 5)),
            lambda args, topo, mode: cm.ring_matmul_rs(
                to_torch(args[0]), to_torch(args[1]), topo, mode),
            lambda r, rtopo, mode: lambda a, c: r.collective_matmul.
            ring_matmul_rs(a, c, rtopo, mode)),
    }


@pytest.mark.parametrize("n,name", [(4, "ring"), (2, "ring")])
@pytest.mark.parametrize("op", ["ring_attention", "ring_decode",
                                "ring_ag_matmul", "ring_matmul_rs"])
@pytest.mark.parametrize("mode", MODES)
def test_ring_op_counts_equal_reference(ref, n, name, op, mode):
    """Each ring op's totals equal the reference's device sums: queue
    traffic in the ring modes (prefill K/V counted as the reference's one
    stacked queue), multicast loads in the baseline. Values stay those of
    an unrecorded run."""
    import repro.core.collective_matmul  # noqa: F401 (for r.core.*)
    import repro.core.ring_attention  # noqa: F401
    from repro.core import topology as rtp
    args, port_fn, ref_fn = _ring_cases(n)[op]
    topo, rtopo = tp.resolve(name, "model", n), rtp.resolve(name, "model", n)
    out, got = _port_totals(lambda: port_fn(args, topo, mode))
    _, want = _ref_totals(ref_fn(ref.core, rtopo, mode), *args,
                          axis="model")
    assert got == want
    assert (got["mcast_bytes"] > 0) == (mode == "baseline")
    assert (got["pushes"] > 0) == (mode != "baseline")
    plain = port_fn(args, topo, mode)
    for a, b in zip(out if isinstance(out, list) else [out],
                    plain if isinstance(plain, list) else [plain]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", queues.MODES)
def test_cannon_and_halo_counts_equal_reference(ref, mode):
    """Cannon's masked skew books its n-1 hops per operand, then the main
    loop's hops; the halo exchange two hops."""
    from repro.core import collective_matmul as rcm
    from repro.core import halo as rhalo
    from repro.core.topology import Topology as RTopology
    from repro.core.topology import torus_shift as rtorus
    n = 3
    rng = np.random.default_rng(5)
    a, b = _rand(rng, n * n, 2, 3), _rand(rng, n * n, 3, 4)
    rt, ct = (rtorus("pe", n, n, direction=d) for d in ("right", "down"))
    left = RTopology("left", "pe", n * n, tuple((d, s) for s, d in rt.perm))
    up = RTopology("up", "pe", n * n, tuple((d, s) for s, d in ct.perm))
    pleft, pup = cm.cannon_topologies("pe", n, n)
    _, got = _port_totals(lambda: cm.cannon_matmul(
        to_torch(a), to_torch(b), pleft, pup, n, n, mode))
    _, want = _ref_totals(lambda x, y: rcm.cannon_matmul(
        x, y, left, up, n, n, mode), a, b)
    assert got == want
    skew = 2 * (n - 1) * n * n                    # two operands, every PE
    assert got["pushes"] == skew + 2 * (n - 1) * n * n
    x = _rand(rng, 4, 3, 5)
    _, got = _port_totals(lambda: halo.exchange_halo(to_torch(x), 4, 1, mode))
    _, want = _ref_totals(lambda v: rhalo.exchange_halo(v, "pe", 4, 1, mode),
                          x)
    assert got == want and got["pushes"] == 2 * 4


def test_multicast_and_gather_store(ref):
    from repro.core import queues as rq
    x = _rand(np.random.default_rng(2), N, 3, 2)
    out, got = _port_totals(lambda: queues.multicast(to_torch(x)))
    want_out, want = _ref_totals(lambda v: rq.multicast(v, "pe"), x)
    assert got == want and got["mcast_bytes"] == N * x.nbytes
    assert got["pushes"] == 0                 # multicast is not queue traffic
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    y = to_torch(x)
    assert queues.gather_store(y) is y


# --- scopes: gating, mute, unarmed -------------------------------------------
def _stream_once(mode="qlr"):
    return queues.stream(tp.ring("pe", N), torch.from_numpy(_payload()),
                         N_STEPS, lambda s, b, t: s + b, torch.zeros(N, 3),
                         mode)


def test_enable_gating_and_mute():
    with linkstats.collect(0) as off:
        _stream_once()
    assert all(v == 0 for v in off.stats.as_dict().values())
    with linkstats.collect(1) as sc:
        with linkstats.mute():
            assert not linkstats.armed()
            _stream_once()                    # hidden from the outer scope
        linkstats.record_hops(torch.ones(N, 3))
    assert sc.stats.as_dict()["pushes"] == N


def test_unarmed_paths_record_nothing_and_observe_purely():
    assert not linkstats.armed()
    plain = _stream_once()
    with linkstats.collect() as sc:
        armed = _stream_once()
    assert sc.stats.as_dict()["pushes"] == N * N_STEPS
    assert all(torch.equal(a, b) for a, b in zip(plain, armed))
    assert not linkstats.armed()


def test_byte_totals_exact_past_2_24():
    """The reference's float32 byte counters round above 2**24 bytes; the
    port's integers stay exact (meta tensors: no memory is allocated)."""
    big = torch.empty((3, 2 ** 23 + 1), dtype=torch.int8, device="meta")
    one = torch.empty((1, 1), dtype=torch.int8, device="meta")
    with linkstats.collect() as sc:
        linkstats.record_hops(big, 2)
        linkstats.record_hops(one)              # one byte more
        linkstats.record_multicast(big, fan_in=3)
    d = sc.stats.as_dict()
    want = 2 * 3 * (2 ** 23 + 1) + 1
    assert d["payload_bytes"] == want and isinstance(d["payload_bytes"], int)
    assert d["mcast_bytes"] == 3 * 3 * (2 ** 23 + 1)
    # float32 cannot hold it: 2**24 < want and want is odd
    assert int(np.float32(want)) != want
    assert d["pushes"] == 2 * 3 + 1


# --- the paper's issue-slot model on measured counts -------------------------
def test_energy_account_equals_reference(ref):
    from repro.core import energy as renergy
    for f in ("pj_per_flop", "pj_per_byte_local", "pj_per_byte_remote",
              "pj_per_byte_link", "pj_per_instr_overhead", "name"):
        assert getattr(energy.MEMPOOL, f) == getattr(renergy.MEMPOOL, f)
    kw = dict(flops=3.5e6, local_bytes=1e4, remote_bytes=2e5,
              link_bytes=7e5, instr_overhead_ops=1.25e5)
    got = energy.account(energy.MEMPOOL, **kw)
    want = renergy.account(renergy.MEMPOOL, **kw)
    assert got.__dict__ == want.__dict__
    assert got.summary() == want.summary()


@pytest.mark.parametrize("mode", MODES)
def test_utilization_report_equals_reference(ref, mode):
    """The same measured counters (a ring op's telemetry) give the same
    utilization, energy and table as the reference's model."""
    from repro.obs import utilization as rutil
    args, port_fn, _ = _ring_cases(N)["ring_ag_matmul"]
    _, stats = _port_totals(lambda: port_fn(args, tp.ring("model", N), mode))
    flops = 2.0 * N * 2 * N * 3 * 8 * (5 + 6)
    got = utilization.report(stats, flops=flops, mode=mode)
    want = rutil.report(stats, flops=flops, mode=mode)
    for f in ("mode", "flops", "macs", "queue_words", "load_words",
              "queue_ops", "stall", "utilization", "errors"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.energy.__dict__ == want.energy.__dict__
    assert got.summary() == want.summary()
    assert utilization.table([got]) == rutil.table([want])
    assert 0.0 < got.utilization <= 1.0


# --- a serving backend as a whole --------------------------------------------
BACKEND_RINGS = (2,)            # SMOKE's 2 KV heads engage the QKV ring at 2
BACKEND_SCFG = dict(max_batch=4, max_seq_len=32, prefill_chunk=8)


def _backend_calls(backend):
    """Totals after one block prefill, then after one decode step."""
    backend.prefill(1, np.arange(5, dtype=np.int32))
    out = {"prefill": dict(backend.link_stats())}
    backend.step(np.ones((4, 1), np.int32), np.ones(4, bool))
    out["decode"] = dict(backend.link_stats())
    return out


def _reference_backends(out_path: str) -> None:
    """The reference's telemetry ring backend on 1 x n fake devices (Auto
    axes: jax 0.9's default Explicit axes refuse the reference's sharding
    constraints); its totals saved to ``out_path``."""
    from jax.sharding import AxisType

    from test_torch_reference import load_reference
    load_reference()
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.sharded_cache import RingShardedBackend as RBackend
    rcfg, _ = smoke_fp32()
    _, rparams, _ = reference_model(rcfg)
    res = {}
    for n in BACKEND_RINGS:
        mesh = jax.make_mesh((1, n), ("data", "model"),
                             devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * 2)
        res[n] = _backend_calls(RBackend(rcfg, RServeConfig(**BACKEND_SCFG),
                                         rparams, mesh, mode="qlr",
                                         telemetry=True))
    Path(out_path).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def reference_backend_totals(tmp_path_factory):
    out = tmp_path_factory.mktemp("backend_ref") / "totals.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), str(Path(__file__).parent),
                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, str(out)], check=True,
                   env=env, timeout=600)
    return json.loads(out.read_text())


@pytest.mark.parametrize("n_pe", BACKEND_RINGS)
def test_backend_totals_equal_reference(ref, reference_backend_totals, n_pe):
    """A telemetry ring backend's totals after a block prefill (QKV and
    FFN rings, ring attention) and a decode step (ring decode) equal the
    reference backend's on the same weights: the model's layer loop
    records each layer once, as the reference's ``linkstats.scan`` sums
    them."""
    _, cfg = smoke_fp32()
    _, _, tree = reference_model(smoke_fp32()[0])
    params = params_from_reference(tree, cfg, device="cpu")
    got = _backend_calls(RingShardedBackend(
        cfg, ServeConfig(**BACKEND_SCFG), params, n_pe, "qlr",
        telemetry=True, device="cpu"))
    assert got == reference_backend_totals[str(n_pe)]
    assert got["decode"]["pushes"] > got["prefill"]["pushes"] > 0


if __name__ == "__main__":
    _reference_backends(sys.argv[1])
