"""The port's DSP suite against the JAX reference: the conv2d and FFT-stage
twins, open-chain hops, the halo exchange and Cannon per PE, and the whole
conv2d, pipeline and cfft paths.

Inputs come from a numpy seed and go unchanged to both packages; on the CPU
each kernel wrapper takes its plain twin. Bounds are those of
``tests/test_kernels.py``: conv2d 1e-4 in fp32 and 5e-2 in bf16, a whole
FFT 1e-3 (relative to numpy). An FFT stage is held to 1e-5, the ring ops
per PE to 1e-5 (conv) and 1e-4 relative (Cannon).

The reference's ring bodies run per PE under ``jax.vmap(axis_name="pe")``.
Its vmap rule for ``ppermute`` refuses a permutation that leaves a PE
without a source, so the open-chain hops and the reference's ``pipelined``
and ``pipelined_fft`` run under ``shard_map`` on 8 fake CPU devices, in one
subprocess (this file run as a script) whose outputs the tests read back.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import SRC, ref, to_torch  # noqa: F401 (fixture)

from repro_torch.core import collective_matmul as cm
from repro_torch.core import fft, halo, pipeline, queues
from repro_torch.core import topology as tp
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.fft import kernel as fk
from repro_torch.kernels.fft import ops as fft_ops

MODES = ("baseline", "sw", "xqueue", "qlr")
CHAINS = (1, 2, 4)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _vmap(fn, *args, in_axes=0):
    return jax.jit(jax.vmap(fn, in_axes=in_axes, axis_name="pe"))(
        *map(jnp.asarray, args))


# ---------------------------------------------------------------------------
# the reference on 8 fake devices (subprocess)
# ---------------------------------------------------------------------------


def _mesh_inputs():
    rng = np.random.default_rng(7)
    return {"hop_x": _rand(rng, 8, 3, 2),
            "pipe_xs": _rand(rng, 8, 3),
            "pipe_params": _rand(rng, 8, 2),
            "fft_xs": _crand(rng, 4, 2, 256)}


def _mesh_reference(out_path: str) -> None:
    """The reference's open-chain hops, ``pipelined`` with affine stages and
    ``pipelined_fft``, under shard_map; saved to ``out_path``."""
    from jax.sharding import PartitionSpec as P

    from test_torch_reference import load_reference
    load_reference()
    from repro.compat import shard_map
    from repro.core import queues as rq
    from repro.core.fft import pipelined_fft
    from repro.core.pipeline import pipelined
    from repro.core.topology import chains
    from repro.launch.mesh import make_mesh

    inp = _mesh_inputs()
    mesh8, mesh4 = make_mesh((8,), ("pe",)), make_mesh((4,), ("pe",))
    keys = [(k, m) for k in CHAINS for m in queues.MODES]

    def hops(v):
        return [rq.hop(chains("pe", 8, k), v, m) for k, m in keys]

    res = dict(zip((f"hop_{k}_{m}" for k, m in keys), jax.jit(shard_map(
        hops, mesh=mesh8, in_specs=P("pe"), out_specs=[P("pe")] * len(keys),
        check_vma=False))(inp["hop_x"])))
    for k in CHAINS:
        for mode in ("qlr", "xqueue"):
            fn = jax.jit(pipelined(lambda p, x, i: x * p[0] + p[1], mesh8,
                                   "pe", 8, mode=mode, n_chains=k))
            res[f"pipe_{k}_{mode}"] = fn(inp["pipe_params"][:8 // k],
                                         inp["pipe_xs"])
    res["pfft"] = jax.jit(
        lambda v: pipelined_fft(v, mesh4, "pe", mode="qlr"))(inp["fft_xs"])
    res = {key: np.asarray(val) for key, val in res.items()}
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), str(Path(__file__).parent),
                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, str(out)], check=True,
                   env=env, timeout=600)
    with np.load(out) as data:
        return dict(data)


# ---------------------------------------------------------------------------
# configs, tables, helpers
# ---------------------------------------------------------------------------


def test_dsp_configs_match_reference(ref):
    from dataclasses import asdict

    from repro.configs import mempool_dsp as rdsp
    from repro_torch.configs import mempool_dsp as dsp
    for name in ("MATMUL", "CONV2D", "CFFT"):
        assert asdict(getattr(dsp, name)) == asdict(getattr(rdsp, name))
    assert asdict(dsp.DSPConfig("x", "conv2d")) == \
        asdict(rdsp.DSPConfig("x", "conv2d"))


def test_fft_tables_match_reference(ref):
    from repro.core import fft as rfft
    for n in (16, 64, 256):
        d = fft.n_stages_of(n)
        perm = fft.digit_reverse_indices(n)
        np.testing.assert_array_equal(perm, rfft.digit_reverse_indices(n))
        np.testing.assert_array_equal(fk.digit_reverse(n, d, "cpu").numpy(),
                                      perm)
        for s in range(d):
            np.testing.assert_array_equal(fft.stage_twiddles(n, s, d),
                                          rfft.stage_twiddles(n, s, d))
    args = [np.complex64(v) for v in (1 + 2j, -1j, 3, 0.5 - 1j)]
    for got, want in zip(fft.radix4_butterfly(*args),
                         rfft.radix4_butterfly(*args)):
        assert got == want


def test_halo_traffic_and_bubble_match_reference(ref):
    from repro.core import halo as rhalo
    from repro.core import pipeline as rpipe
    for args in [(256, 256, 256, 1), (256, 128, 8, 4), (64, 32, 8, 2, 2, 2)]:
        assert halo.halo_traffic(*args) == rhalo.halo_traffic(*args)
    for s, m in [(8, 16), (2, 8), (4, 0), (1, 4)]:
        assert pipeline.bubble_fraction(s, m) == rpipe.bubble_fraction(s, m)


# ---------------------------------------------------------------------------
# the kernels' twins against the reference kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,bm", [
    (256, 256, 128), (128, 64, 32), (64, 256, 64),
    # a vector multiple (4 fp32 or 8 bf16 columns a lane in the 16-byte
    # body) +- 1, where the kernel leaves that body for the generic one
    (64, 127, 32), (64, 129, 32), (48, 255, 16), (48, 257, 16),
    # h not a multiple of bm: the reference kernel cannot tile it
    (50, 127, 32), (50, 129, 32), (70, 1023, 64), (70, 1025, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_twin_vs_reference(ref, h, w, bm, dtype):
    """Port ``ops.conv2d`` (plain twin) == the reference Pallas kernel in
    interpret mode (where bm tiles h; else the reference's per-PE
    ``conv2d_3x3_local`` under vmap, on the zero-extended image) == the
    reference's jnp oracle on fp32 inputs."""
    from repro.core.halo import conv2d_3x3_local as rconv_local
    from repro.core.halo import conv2d_ref as rconv_ref
    from repro.kernels.conv2d.kernel import conv2d_3x3 as rconv
    rng = np.random.default_rng(h + w)
    x, k = _rand(rng, h, w), _rand(rng, 3, 3)
    xj, kj = jnp.asarray(x).astype(dtype), jnp.asarray(k).astype(dtype)
    if h % bm == 0:
        want = rconv(xj, kj, bm=bm, interpret=True)
    else:
        want = _vmap(rconv_local, jnp.pad(xj, ((1, 1), (0, 0)))[None], kj,
                     in_axes=(0, None))[0]
    xt = to_torch(x).to(TORCH_DTYPES[dtype])
    got = conv_ops.conv2d(xt, to_torch(k).to(TORCH_DTYPES[dtype]))
    assert got.dtype == xt.dtype and got.shape == (h, w)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    _close(got.float(), np.asarray(want, np.float32), tol)
    oracle = rconv_ref(xj.astype(jnp.float32), kj.astype(jnp.float32))
    _close(got.float(), oracle, tol)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fft_stage_twin_vs_reference(ref, stage):
    """One stage of the port (interleaved complex) == the reference Pallas
    stage kernel in interpret mode (split real/imaginary planes)."""
    from repro.core.fft import stage_twiddles
    from repro.kernels.fft.kernel import fft_stage as rstage
    rng = np.random.default_rng(stage)
    x = _crand(rng, 16, 256)
    tw = stage_twiddles(256, stage, 4)
    want_r, want_i = rstage(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        jnp.asarray(tw.real, jnp.float32), jnp.asarray(tw.imag, jnp.float32),
        stage=stage, bb=8, interpret=True)
    got = fft.fft_stage(torch.from_numpy(x), stage)
    _close(got.real, want_r, 1e-5)
    _close(got.imag, want_i, 1e-5)


def test_fft_stage_kernel_mixed_stages_per_row(ref):
    """Rows at different stages in one call (one pipeline tick), with the
    digit-reversed load on the stage-0 rows, equal the per-stage programs;
    a row at a stage that does not exist comes out NaN."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_crand(rng, 5, 3, 256))
    stage = torch.tensor([2, 0, 3, 1, 7], dtype=torch.int32)
    got = fk.fft_stage(x, stage, fft.twiddle_table(256, "cpu"), reverse=True)
    perm = torch.from_numpy(fft.digit_reverse_indices(256))
    for row, s in enumerate(stage.tolist()[:4]):
        src = x[row][:, perm] if s == 0 else x[row]
        torch.testing.assert_close(got[row], fft.fft_stage(src, s),
                                   rtol=0, atol=0)
    assert bool(torch.isnan(got[4]).all())


@pytest.mark.parametrize("batch", [16, 64])
def test_fft256_vs_reference(ref, batch):
    from repro.core.fft import fft256_radix4 as rfft256
    from repro.kernels.fft.ref import fft_ref
    rng = np.random.default_rng(batch)
    x = _crand(rng, batch, 256)
    got = fft_ops.fft256(torch.from_numpy(x))
    _close(got, fft_ref(jnp.asarray(x)), 1e-3)
    _close(got, jax.jit(rfft256)(jnp.asarray(x)), 1e-3)
    assert _rel_err(got, np.fft.fft(x, axis=-1)) < 1e-5


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_fft_full_plain_is_the_stages_bit_for_bit(n):
    """The one-launch transform's twin equals D single-stage calls, the
    first loading digit-reversed, bit for bit."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_crand(rng, 6, n))
    tw = fft.twiddle_table(n, "cpu")
    want = x[None]
    for s in range(fft.n_stages_of(n)):
        want = fk.stage_plain(want, torch.tensor([s], dtype=torch.int32), tw,
                              reverse=(s == 0))
    assert torch.equal(fk.fft_full_plain(x, tw), want[0])
    assert torch.equal(fk.fft_full(x, tw), want[0])     # CPU: the twin


def test_fft256_radix4_goes_through_fft_full(ref, monkeypatch):
    """fft256 is one fft_full call, and still matches the reference's
    fft256 at test_fft256_vs_reference's bound."""
    from repro.core.fft import fft256_radix4 as rfft256
    calls = []

    def counted(x, tw):
        calls.append(tuple(x.shape))
        return fk.fft_full(x, tw)
    monkeypatch.setattr(fft, "fft_full", counted)
    x = _crand(np.random.default_rng(11), 2, 8, 256)
    got = fft.fft256_radix4(torch.from_numpy(x))
    assert calls == [(16, 256)]
    assert got.shape == x.shape
    _close(got, jax.jit(rfft256)(jnp.asarray(x)), 1e-3)
    assert _rel_err(got, np.fft.fft(x, axis=-1)) < 1e-5


def test_fft_above_the_shared_memory_row_runs_stage_by_stage(monkeypatch):
    """n > FULL_MAX_N does not fit one block's shared memory: those
    transforms keep one launch per stage."""
    n = 4 * fk.FULL_MAX_N
    monkeypatch.setattr(fft, "fft_full", None)          # must not be called
    x = _crand(np.random.default_rng(12), 2, n)
    got = fft.fft256_radix4(torch.from_numpy(x), n)
    assert _rel_err(got, np.fft.fft(x, axis=-1)) < 1e-5


def test_fft256_impulse(ref):
    from repro.kernels.fft.ref import fft_ref
    x = np.zeros((4, 256), np.complex64)
    x[:, 1] = 1.0
    got = fft_ops.fft256(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(fft_ref(x)),
                               atol=1e-4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back to the twin: tensors that are
    not on the card raise before anything is built."""
    from repro_torch.kernels.conv2d import kernel as ck
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ck.conv_cuda(x, None, None, torch.zeros(3, 3))
    xc = torch.zeros(1, 2, 256, dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        fk.stage_cuda(xc, torch.zeros(1, dtype=torch.int32),
                      fft.twiddle_table(256, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        fk.fft_full_cuda(xc[0], fft.twiddle_table(256, "cpu"))


# ---------------------------------------------------------------------------
# hops over open chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", CHAINS)
@pytest.mark.parametrize("mode", queues.MODES)
def test_chain_hop_matches_reference(mesh_ref, k, mode):
    """Chain heads pop zeros, as ``ppermute`` gives them, in every mode."""
    x = to_torch(_mesh_inputs()["hop_x"])
    topo = tp.chains("pe", 8, k)
    got = queues.hop(topo, (x, 2 * x), mode)
    np.testing.assert_array_equal(got[0].numpy(), mesh_ref[f"hop_{k}_{mode}"])
    np.testing.assert_array_equal(got[1].numpy(),
                                  2 * mesh_ref[f"hop_{k}_{mode}"])
    heads = list(range(0, 8, 8 // k))
    assert not got[0][heads].any() and got[0].abs().sum() > 0


def test_cycle_hop_leaves_no_row_zeroed():
    x = torch.arange(1.0, 9.0).reshape(4, 2)
    for topo in (tp.ring("pe", 4), tp.snake_fold("pe", 2, 2),
                 tp.torus_shift("pe", 2, 2, direction="down")):
        for mode in queues.MODES:
            assert bool(queues.hop(topo, x, mode).all())


# ---------------------------------------------------------------------------
# ring ops per PE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,r,w,h", [(4, 3, 10, 1), (8, 1, 12, 1),
                                     (4, 3, 7, 2)])
@pytest.mark.parametrize("mode", queues.MODES)
def test_exchange_halo_and_local_conv_per_pe(ref, n, r, w, h, mode):
    """Halo rows and the local conv per PE equal the reference bodies; the
    (8, 1) case has one image row per PE, so the halo is the whole block."""
    from repro.core import halo as rhalo
    rng = np.random.default_rng(n * r + w)
    x, k = _rand(rng, n, r, w), _rand(rng, 3, 3)
    want_ext = _vmap(lambda v: rhalo.exchange_halo(v, "pe", n, h, mode), x)
    top, bot = halo.exchange_halo(to_torch(x), n, h, mode)
    np.testing.assert_array_equal(torch.cat([top, to_torch(x), bot], 1),
                                  np.asarray(want_ext))
    if h != 1:
        return
    want = _vmap(lambda v, kk: rhalo.conv2d_3x3_local(
        rhalo.exchange_halo(v, "pe", n, 1, mode), kk), x, k,
        in_axes=(0, None))
    got = halo.conv2d_3x3_local(to_torch(x), top, bot, to_torch(k))
    _close(got, want, 1e-5)


def _cannon_inputs(rng, n, m, kk, nn):
    return _rand(rng, n * n, m, kk), _rand(rng, n * n, kk, nn)


@pytest.mark.parametrize("preskewed", [False, True])
@pytest.mark.parametrize("mode", queues.MODES)
def test_cannon_matmul_per_pe(ref, preskewed, mode):
    """4x4 fold, masked skew: every PE's C tile equals the reference's."""
    from repro.core import collective_matmul as rcm
    from repro.core.topology import Topology as RTopology
    from repro.core.topology import torus_shift as rtorus
    n = 4
    rng = np.random.default_rng(11)
    a, b = _cannon_inputs(rng, n, 3, 2, 5)
    rt, ct = (rtorus("pe", n, n, direction=d) for d in ("right", "down"))
    left = RTopology("left", "pe", n * n, tuple((d, s) for s, d in rt.perm))
    up = RTopology("up", "pe", n * n, tuple((d, s) for s, d in ct.perm))
    want = _vmap(lambda x, y: rcm.cannon_matmul(
        x, y, left, up, n, n, mode, preskewed=preskewed), a, b)
    pleft, pup = cm.cannon_topologies("pe", n, n)
    assert (pleft.perm, pup.perm) == (left.perm, up.perm)
    got = cm.cannon_matmul(to_torch(a), to_torch(b), pleft, pup, n, n, mode,
                           preskewed=preskewed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    base = cm.cannon_matmul(to_torch(a), to_torch(b), pleft, pup, n, n,
                            "baseline", preskewed=preskewed)
    assert torch.equal(got, base)


def test_cannon_matmul_refuses_what_it_cannot_run():
    left, up = cm.cannon_topologies("pe", 2, 2)
    a = torch.arange(16.0).reshape(4, 2, 2)
    # the one-hop grid skew is ported: it gives the masked skew's values
    assert torch.equal(cm.cannon_matmul(a, a, left, up, 2, 2, skew="grid"),
                       cm.cannon_matmul(a, a, left, up, 2, 2))
    with pytest.raises(ValueError):
        cm.cannon_matmul(a, a, left, up, 2, 2, skew="bogus")
    with pytest.raises(ValueError):
        cm.cannon_matmul(a, a, left, up, 2, 3)
    with pytest.raises(ValueError):
        cm.cannon_matmul(a[:3], a[:3], left, up, 2, 2)


# ---------------------------------------------------------------------------
# whole paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_systolic_cannon_equals_dense(mode):
    rng = np.random.default_rng(12)
    a, b = _rand(rng, 32, 24), _rand(rng, 24, 16)
    got = cm.systolic_cannon(to_torch(a), to_torch(b), 4, mode)
    want = a.astype(np.float64) @ b
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n_pe", [8, 64])
def test_conv2d_systolic_vs_reference(ref, n_pe):
    """Every mode equals the reference oracle, and all four are identical;
    n_pe = 64 gives each PE one row of the 64-row image."""
    from repro.core.halo import conv2d_ref as rconv_ref
    rng = np.random.default_rng(n_pe)
    x, k = _rand(rng, 64, 32), _rand(rng, 3, 3)
    want = rconv_ref(jnp.asarray(x), jnp.asarray(k))
    outs = [halo.conv2d_systolic(to_torch(x), to_torch(k), n_pe, mode)
            for mode in MODES]
    for got in outs:
        _close(got, want, 1e-4)
        assert torch.equal(got, outs[0])
    _close(halo.conv2d_ref(to_torch(x), to_torch(k)), want, 1e-5)


def _affine(p, x, stage_idx):
    return x * p[:, :1] + p[:, 1:]


@pytest.mark.parametrize("k", CHAINS)
@pytest.mark.parametrize("mode", ["qlr", "xqueue"])
def test_pipelined_affine_vs_reference(mesh_ref, k, mode):
    """Affine stages x*a_s + b_s (order matters): equal to the reference's
    ``pipelined`` under shard_map and to the stages applied in turn; the
    other modes give identical values."""
    inp = _mesh_inputs()
    n_stages = 8 // k
    params, xs = to_torch(inp["pipe_params"][:n_stages]), \
        to_torch(inp["pipe_xs"])
    got = pipeline.pipelined(_affine, 8, 8, mode, k)(params, xs)
    _close(got, mesh_ref[f"pipe_{k}_{mode}"], 1e-5)
    want = xs.clone()
    for s in range(n_stages):
        want = want * params[s, 0] + params[s, 1]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for other in ("baseline", "sw"):
        assert torch.equal(pipeline.pipelined(_affine, 8, 8, other, k)(
            params, xs), got)


@pytest.mark.parametrize("k", CHAINS)
def test_pipelined_closed_forms(k):
    """The reference multidev check's cases: x + sum(params) per chain
    count, and x * 2 over 8 xqueue stages."""
    xs = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    n_stages = 8 // k
    params = torch.arange(1, n_stages + 1, dtype=torch.float32) \
        .reshape(n_stages, 1)
    ys = pipeline.pipelined(lambda p, x, i: x + p, 8, 8, "qlr", k)(params,
                                                                    xs)
    assert torch.equal(ys, xs + float(sum(range(1, n_stages + 1))))
    ys = pipeline.pipelined(lambda p, x, i: x * 2.0, 8, 8, "xqueue")(None, xs)
    assert torch.equal(ys, xs * 256.0)


def test_pipelined_fft_vs_reference(ref, mesh_ref):
    """Every mode equals the reference's ``pipelined_fft`` on 4 fake devices,
    its ``fft256_radix4`` and numpy; the four modes are identical."""
    from repro.core.fft import fft256_radix4 as rfft256
    xs = _mesh_inputs()["fft_xs"]
    outs = [fft.pipelined_fft(torch.from_numpy(xs), 4, mode)
            for mode in MODES]
    want = np.fft.fft(xs, axis=-1)
    for got in outs:
        assert torch.equal(got, outs[0])
    assert _rel_err(outs[0], want) < 1e-3
    assert _rel_err(outs[0], mesh_ref["pfft"]) < 1e-5
    assert _rel_err(outs[0], jax.jit(rfft256)(jnp.asarray(xs))) < 1e-5


@pytest.mark.parametrize("n_pe", [2, 8])
def test_pipelined_fft_needs_one_pe_per_stage(n_pe):
    xs = torch.zeros(4, 2, 256, dtype=torch.complex64)
    with pytest.raises(ValueError, match="n_pe must be 4"):
        fft.pipelined_fft(xs, n_pe, "qlr")


if __name__ == "__main__":
    _mesh_reference(sys.argv[1])
