"""The port's training path against the reference: loss, gradients,
AdamW, the train step, data, checkpoints and the launcher.

SMOKE qwen3-0.6b in fp32 with the reference's own weights (carried by
``params_from_reference``) and inputs from a numpy seed. Bounds:

- optimizer functions on a random tree: 1e-6 relative (fp32, the same
  elementwise formulas);
- loss 1e-4 and gradients 1e-3, those of
  ``tests/multidev/check_systolic_model.py`` (the ring against the dense
  path);
- three train steps: loss, ``grad_norm`` and ``lr`` 1e-4 relative;
  parameters and master weights within ``2 * lr`` per step: AdamW
  normalises every gradient element (its first update is about
  ``sign(g)``), so an element whose gradient is near zero may move by
  ``+lr`` in one package and ``-lr`` in the other. Away from such
  elements both take the same update, so 99.9% of the parameters must
  also agree to 1% of the rate. Moments: 1e-3 of their largest value,
  as the gradients.

The ring variants run the emulated ring at the SMOKE widths through the
kernel wrappers' CPU twins. ``test_kernel_functions_*`` routes the wrappers
through the ``autograd.Function``s the card path takes, with the twins
standing in for the kernels (the flash hop's backward twin for its
backward kernel), so their backward and the launches a step makes under
remat are held here too.
"""
from __future__ import annotations

import json
import signal
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

from repro_torch.configs import TrainConfig
from repro_torch.data import pipeline as data
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.kernels.systolic_matmul import ops as mm_ops
from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
    state_from_reference,
    state_to_reference,
)
from repro_torch.models.common import lm_loss_chunked
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(4, "xqueue", id="ring4-xqueue")]
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3
B, S = 2, 16


@pytest.fixture(scope="module")
def smoke(ref):
    rcfg, cfg = smoke_fp32()
    rmodel, rparams, tree = reference_model(rcfg)
    return rcfg, cfg, rmodel, rparams, tree


def _batch(vocab, seed=3, mask=True):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": raw[:, :-1], "targets": raw[:, 1:]}
    if mask:
        out["mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaves(tree):
    """{path: numpy array} of a reference-layout tree."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, rtol, atol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _random_tree(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype),
                  "d": (rng.standard_normal((3, 7)) * 1e-3).astype(dtype)}}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree, dtype=torch.float32):
    return opt.tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32))
                        .to(dtype), tree)


def _np(tree):
    return opt.tree_map(lambda t: t.float().numpy() if torch.is_tensor(t)
                        else np.asarray(t, np.float32), tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_vs_reference(ref, schedule):
    from repro.train import optimizer as ropt
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=110,
                       schedule=schedule)
    for step in (0, 1, 5, 10, 37, 60, 109, 110, 500):
        want = float(ropt.learning_rate(tcfg, jnp.asarray(step)))
        got = float(opt.learning_rate(tcfg, torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("max_norm", [0.01, 1e3])
def test_clip_by_global_norm_vs_reference(ref, max_norm):
    from repro.train import optimizer as ropt
    tree = _random_tree(1)
    want, want_norm = ropt.clip_by_global_norm(_jax(tree), max_norm)
    got, norm = opt.clip_by_global_norm(_torch(tree), max_norm)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
    for k, v in _leaves(want).items():
        np.testing.assert_allclose(_leaves(_np(got))[k], v, rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("method", ["none", "bf16", "fp8sim"])
def test_grad_compression_vs_reference(ref, method):
    from repro.train import optimizer as ropt
    tree = _random_tree(2)
    want = ropt.decompress_gradients(ropt.compress_gradients(_jax(tree),
                                                             method))
    got = opt.decompress_gradients(opt.compress_gradients(_torch(tree),
                                                          method))
    for k, v in _leaves(want).items():
        np.testing.assert_allclose(_leaves(_np(got))[k], v, rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("master", [True, False])
def test_adamw_update_vs_reference(ref, master):
    """Two AdamW steps on a random tree: bf16 params over fp32 master
    weights, or fp32 params updated in place of them."""
    from repro.train import optimizer as ropt
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10,
                       use_master_weights=master)
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if master
               else (torch.float32, jnp.float32))
    params = _random_tree(3)
    rparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    pparams = _torch(params, dt)
    rstate = ropt.init_opt_state(rparams, tcfg)
    pstate = opt.init_opt_state(pparams, tcfg)
    for i in range(2):
        grads = _random_tree(10 + i)
        rparams, rstate, rlr = ropt.adamw_update(_jax(grads), rstate,
                                                 rparams, tcfg)
        pparams, pstate, lr = opt.adamw_update(_torch(grads), pstate,
                                               pparams, tcfg)
        assert float(lr) == pytest.approx(float(rlr), rel=1e-6)
    assert int(pstate["step"]) == int(rstate["step"]) == 2
    for name in ("m", "v") + (("master",) if master else ()):
        for k, v in _leaves(rstate[name]).items():
            np.testing.assert_allclose(_leaves(_np(pstate[name]))[k], v,
                                       rtol=1e-6, atol=1e-12, err_msg=name)
    for k, v in _leaves(rparams).items():
        got = _leaves(_np(pparams))[k]
        # bf16 params: one rounding of master weights that agree to 1e-6
        np.testing.assert_allclose(got, v, rtol=1e-6 if not master
                                   else 2 ** -8, atol=1e-12)
    assert all(t.dtype == dt for t in opt.tree_leaves(pparams))


def test_adamw_update_moments_in_place_masters_and_params_new():
    """The moments are updated in place and shared with the state
    returned; masters and params are new tensors, so a caller still holds
    the ones it had unchanged (the benchmark's check measures the change
    from them)."""
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    params = _torch(_random_tree(3), torch.bfloat16)
    state = opt.init_opt_state(params, tcfg)
    m, v = opt.tree_leaves(state["m"]), opt.tree_leaves(state["v"])
    masters = opt.tree_leaves(state["master"])
    before = [t.clone() for t in masters + opt.tree_leaves(params)]
    new_params, new_state, _ = opt.adamw_update(_torch(_random_tree(10)),
                                                state, params, tcfg)
    assert all(a is b for a, b in zip(opt.tree_leaves(new_state["m"]), m))
    assert all(a is b for a, b in zip(opt.tree_leaves(new_state["v"]), v))
    assert all(bool(t.abs().sum() > 0) for t in m + v)
    for old, now in zip(masters + opt.tree_leaves(params), before):
        assert torch.equal(old, now)
    moved = opt.tree_leaves(new_state["master"]) + opt.tree_leaves(new_params)
    assert not any(torch.equal(a, b) for a, b in zip(moved, before))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_grads(smoke):
    rcfg, cfg, rmodel, rparams, tree = smoke
    batch = _batch(cfg.vocab_size)
    (loss, aux), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, _jax(batch))
    return batch, float(loss), float(aux["ce"]), grads


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_loss_and_grads_vs_reference(smoke, reference_grads, n_pe, mode,
                                     remat):
    _, cfg, _, _, tree = smoke
    batch, want_loss, want_ce, want_grads = reference_grads
    cfg = replace(cfg, systolic_mode=mode, remat=remat)
    model = build_model(cfg, n_pe=n_pe)
    params = params_from_reference(tree, cfg, "cpu")
    loss, metrics, grads = step_lib.value_and_grad(model, params,
                                                   _torch_batch(batch))
    assert float(loss) == pytest.approx(want_loss, abs=LOSS_TOL)
    assert float(metrics["ce"]) == pytest.approx(want_ce, abs=LOSS_TOL)
    assert float(metrics["aux"]) == 0.0
    _assert_trees_close(params_to_reference(grads), want_grads,
                        rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_chunked_vs_reference(smoke, masked):
    """Chunks of 4 over 10 positions: two whole chunks and a padded tail;
    the loss and its gradients in x and in the (tied) embedding."""
    from repro.models.common import lm_loss_chunked as r_loss
    rcfg, cfg, _, rparams, tree = smoke
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    mask = ((rng.random((2, 10)) > 0.3).astype(np.float32) if masked
            else None)

    def rfn(x, table):
        return r_loss({}, {"table": table}, x, jnp.asarray(targets), rcfg,
                      mask=None if mask is None else jnp.asarray(mask),
                      chunk=4)

    want, (want_gx, want_gt) = jax.value_and_grad(rfn, argnums=(0, 1))(
        jnp.asarray(x), rparams["embed"]["table"])
    xt = torch.tensor(x, requires_grad=True)
    table = torch.tensor(np.asarray(tree["embed"]["table"]),
                         requires_grad=True)
    got = lm_loss_chunked({}, {"table": table}, xt, torch.as_tensor(targets),
                          cfg, mask=None if mask is None
                          else torch.as_tensor(mask), chunk=4)
    gx, gt = torch.autograd.grad(got, (xt, table))
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(want_gt), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the card path's autograd.Functions, with the twins as their kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_functions(monkeypatch):
    """Route the CPU tile-matmul wrapper through ``_TileMatmul``, whose
    forward calls ``matmul_cuda``: here the twin, counting launches as the
    kernel wrapper does. ``flash_carry`` goes through ``_FlashCarry`` on
    the CPU too: its forward and backward twins stand in for the two
    flash kernels and count their launches."""
    plain_mm = mk.matmul_plain
    plain_flash, plain_bwd = fk.flash_carry_plain, \
        fk.flash_carry_backward_plain
    launches = {"tile_matmul": 0, "flash_carry": 0, "flash_carry_bwd": 0}

    def mm_kernel(a, b, c=None, out_dtype=None, block=0):
        launches["tile_matmul"] += 1
        return plain_mm(a, b, c, out_dtype)

    def flash_kernel(*args, **kw):
        launches["flash_carry"] += 1
        return plain_flash(*args, **kw)

    def flash_bwd_kernel(*args, **kw):
        launches["flash_carry_bwd"] += 1
        return plain_bwd(*args, **kw)

    monkeypatch.setattr(mk, "matmul_cuda", mm_kernel)
    monkeypatch.setattr(mk, "matmul_plain", mm_ops._TileMatmul.apply)
    monkeypatch.setattr(fk, "flash_carry_plain", flash_kernel)
    monkeypatch.setattr(fk, "flash_carry_backward_plain", flash_bwd_kernel)
    return launches


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
def test_kernel_functions_grads_and_launches(smoke, reference_grads,
                                             kernel_functions, remat):
    """On a ring of 2 in qlr the Functions' backward gives the reference's
    gradients, and one step launches each kernel once per hop of the
    forward, and again for every hop the remat backward recomputes."""
    _, cfg, _, _, tree = smoke
    batch, want_loss, _, want_grads = reference_grads
    cfg = replace(cfg, systolic_mode="qlr", remat=remat)
    model = build_model(cfg, n_pe=2)
    params = params_from_reference(tree, cfg, "cpu")
    with torch.no_grad():
        model.loss(params, _torch_batch(batch))
    forward = dict(kernel_functions)
    # per layer: QKV ring 2 hops x 3 sinks, FFN AG 2 x 2, FFN RS 2; ring
    # attention 2 hops
    assert forward == {"tile_matmul": 12 * cfg.num_layers,
                       "flash_carry": 2 * cfg.num_layers,
                       "flash_carry_bwd": 0}
    for k in kernel_functions:
        kernel_functions[k] = 0
    loss, _, grads = step_lib.value_and_grad(model, params,
                                             _torch_batch(batch))
    assert float(loss) == pytest.approx(want_loss, abs=LOSS_TOL)
    _assert_trees_close(params_to_reference(grads), want_grads,
                        rtol=GRAD_TOL, atol=GRAD_TOL)
    # the kernels are no aten products, so "selective" recomputes them too;
    # the flash backward runs once per hop
    times = 1 if remat == "none" else 2
    assert kernel_functions == {**{k: times * v for k, v in forward.items()},
                                "flash_carry_bwd": forward["flash_carry"]}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


STEP_CASES = [
    pytest.param(dict(), id="plain"),
    pytest.param(dict(microbatches=2, grad_compression="bf16"),
                 id="micro2-bf16"),
]


@pytest.mark.parametrize("overrides", STEP_CASES)
def test_train_steps_vs_reference(smoke, overrides):
    from jax.sharding import AxisType
    from repro.train import step as rstep
    rcfg, cfg, _, _, _ = smoke
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       **overrides)
    rstate = rstep.init_state(rcfg, tcfg, jax.random.PRNGKey(5))
    state = state_from_reference(jax.tree_util.tree_map(np.asarray, rstate),
                                 cfg, tcfg, "cpu")
    # a 1x1 mesh; Auto axes, as the reference's sharding constraints need
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    r_train = jax.jit(rstep.make_train_step(rcfg, tcfg, mesh))
    train = step_lib.make_train_step(cfg, tcfg)
    source = data.SyntheticLM(cfg.vocab_size, seed=0)
    lrs = []
    for i in range(3):
        raw = source.batch(i, 4, S)
        batch = {"tokens": raw[:, :-1], "targets": raw[:, 1:]}
        rstate, rmetrics = r_train(rstate, _jax(batch))
        state, metrics = train(state, _torch_batch(batch))
        assert set(metrics) == set(rmetrics)
        for k in rmetrics:
            assert float(metrics[k]) == pytest.approx(
                float(rmetrics[k]), rel=1e-4, abs=1e-7), (i, k)
        lrs.append(float(metrics["lr"]))
    got, want = state_to_reference(state), rstate
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    drift = 2 * sum(lrs)
    _assert_trees_close(got["params"], want["params"], rtol=0, atol=drift)
    _assert_trees_close(got["opt"]["master"], want["opt"]["master"], rtol=0,
                        atol=drift)
    for name in ("m", "v"):
        scale = max(float(np.abs(v).max())
                    for v in _leaves(want["opt"][name]).values())
        _assert_trees_close(got["opt"][name], want["opt"][name], rtol=0,
                            atol=GRAD_TOL * scale)
    # the hard bound admits sign flips; away from them the packages take
    # the same update to fp32 rounding: 99.9% of the elements agree to
    # 1% of the rate
    got_p, want_p = _leaves(got["params"]), _leaves(want["params"])
    diffs = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                            for k in want_p])
    assert np.mean(diffs <= 0.01 * max(lrs)) >= 0.999


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_stream_bit_for_bit(ref):
    from repro.data import pipeline as rdata
    for host_id, host_count in ((0, 1), (1, 2)):
        got = data.DataLoader(data.SyntheticLM(512, seed=7), 4, 32,
                              host_id=host_id, host_count=host_count)
        want = rdata.DataLoader(rdata.SyntheticLM(512, seed=7), 4, 32,
                                host_id=host_id, host_count=host_count)
        try:
            for _ in range(4):
                a, b = next(got), next(want)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
        finally:
            got.close()
            want.close()


def test_mmap_stream_bit_for_bit(ref, tmp_path):
    from repro.data import pipeline as rdata
    path = tmp_path / "tokens.bin"
    np.random.default_rng(8).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    got = data.MmapTokens(str(path), 1000)
    want = rdata.MmapTokens(str(path), 1000)
    for step in range(3):
        np.testing.assert_array_equal(got.batch(step, 3, 17),
                                      want.batch(step, 3, 17))


def test_data_resume_through_state_dict():
    src = data.SyntheticLM(512, seed=1)
    loader = data.DataLoader(src, 4, 16)
    seen = [next(loader) for _ in range(3)]
    state = loader.state_dict()
    after = [next(loader) for _ in range(2)]
    loader.close()
    resumed = data.DataLoader(src, 4, 16)
    resumed.load_state_dict(state)
    try:
        for a, b in zip(after, [next(resumed) for _ in range(2)]):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["targets"], b["targets"])
    finally:
        resumed.close()
    assert state == {"step": 3} and len(seen) == 3


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _bf16_state(seed):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen3-0.6b")
    return step_lib.init_state(cfg, TrainConfig(), seed, "cpu")


def _keyed(tree, prefix=""):
    """{path: tensor} of a port state (list entries by index)."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    return {k: v for key, sub in items
            for k, v in _keyed(sub, f"{prefix}/{key}").items()}


def _assert_states_equal(a, b):
    a, b = _keyed(a), _keyed(b)
    assert a.keys() == b.keys()
    for k, x in a.items():
        assert x.dtype == b[k].dtype and x.shape == b[k].shape, k
        assert torch.equal(x, b[k]), k


def test_checkpoint_round_trip_bf16(tmp_path):
    state = _bf16_state(0)
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(7, state, extra={"data_state": {"step": 7}})
    assert mgr.latest_step() == 7
    meta = mgr.restore_meta(7)
    assert meta["data_state"] == {"step": 7}
    assert meta["dtypes"]["params/layers/attn/wq"] == "bfloat16"
    assert meta["dtypes"]["opt/master/layers/attn/wq"] == "float32"
    assert meta["dtypes"]["opt/step"] == "int32"
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as npz:
        wq = npz["params/layers/attn/wq"]
    # the reference's layout: layers stacked, bf16 as its two bytes
    assert wq.dtype == np.uint8 and wq.shape == (2, 64, 4, 16, 2)
    restored = mgr.restore(7, _bf16_state(1))
    _assert_states_equal(restored, state)


def test_checkpoint_async_and_gc(tmp_path):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    state = _bf16_state(0)
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_atomicity(tmp_path):
    """A half-written tmp dir is never picked up as a restore point, and a
    LATEST marker naming a step without meta falls back to the newest
    complete one."""
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), async_save=False)
    state = _bf16_state(0)
    mgr.save(5, state)
    crash = tmp_path / "step_00000009.tmp"
    crash.mkdir()
    (crash / "arrays.npz").write_bytes(b"partial")
    assert mgr.latest_step() == 5
    (tmp_path / "step_00000011").mkdir()          # no meta.json yet
    (tmp_path / "LATEST").write_text("11")
    assert mgr.latest_step() == 5
    _assert_states_equal(mgr.restore(5, _bf16_state(2)), state)


def test_checkpoint_restore_places_on_target_dtype(tmp_path):
    """Restore follows the target's dtypes (and devices)."""
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), async_save=False)
    state = _bf16_state(0)
    mgr.save(1, state)
    target = opt.tree_map(lambda t: t.float(), _bf16_state(3))
    got = mgr.restore(1, target)
    for x, y in zip(opt.tree_leaves(got), opt.tree_leaves(state)):
        assert x.dtype == torch.float32
        assert torch.equal(x, y.float())


def test_reference_checkpoint_restores_into_port(ref, tmp_path):
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    from repro.train.checkpoint import CheckpointManager as RManager
    from repro_torch.configs import get_smoke_config
    tcfg = TrainConfig()
    rstate = rstep.init_state(r_smoke("qwen3-0.6b"), tcfg,
                              jax.random.PRNGKey(6))
    rstate["opt"]["step"] = jnp.asarray(12, jnp.int32)
    RManager(str(tmp_path), async_save=False).save(12, rstate)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() == 12
    got = mgr.restore(12, _bf16_state(0))
    want = state_from_reference(jax.tree_util.tree_map(np.asarray, rstate),
                                get_smoke_config("qwen3-0.6b"), tcfg, "cpu")
    _assert_states_equal(got, want)
    assert int(got["opt"]["step"]) == 12


def test_port_checkpoint_restores_into_reference(ref, tmp_path):
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    from repro.train.checkpoint import CheckpointManager as RManager
    state = _bf16_state(4)
    ckpt_lib.CheckpointManager(str(tmp_path), async_save=False).save(
        3, state)
    target = rstep.init_state(r_smoke("qwen3-0.6b"), TrainConfig(),
                              jax.random.PRNGKey(0))
    got = RManager(str(tmp_path), async_save=False).restore(3, target)
    assert got["params"]["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    _assert_trees_close(got, state_to_reference(state), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _launch(argv):
    from repro_torch.launch import train as launch
    old = signal.getsignal(signal.SIGTERM)
    try:
        return launch.main(argv)
    finally:
        signal.signal(signal.SIGTERM, old)


def test_launcher_writes_metrics_and_resumes(tmp_path, capsys):
    common = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "16", "--n-pe", "2",
              "--set", "systolic_mode=qlr"]
    run = tmp_path / "run"
    first = _launch(common + ["--steps", "3", "--ckpt-dir", str(run),
                              "--metrics-out", str(tmp_path / "m.json"),
                              "--trace-out", str(tmp_path / "t.json"),
                              "--log", str(tmp_path / "log.jsonl")])
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["counters"]["repro_train_steps_total"] == 3
    assert snap["counters"]["repro_train_tokens_total"] == 3 * 4 * 16
    assert np.isfinite(snap["gauges"]["repro_train_loss"])
    assert (tmp_path / "m.prom").exists()
    spans = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"data", "step", "checkpoint"} <= spans
    # the armed tracer took the port's spans in, and is disarmed
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer", "kernel.tile_matmul"} <= spans
    from repro_torch.obs import trace
    assert trace._armed == 0
    logged = [json.loads(line) for line in
              (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [0, 2]
    assert int(first["opt"]["step"]) == 3

    resumed = _launch(common + ["--steps", "5", "--ckpt-dir", str(run),
                                "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    straight = _launch(common + ["--steps", "5", "--ckpt-dir",
                                 str(tmp_path / "straight")])
    assert int(resumed["opt"]["step"]) == 5
    _assert_states_equal(resumed, straight)


def test_launcher_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _launch(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                 "--ckpt-dir", str(tmp_path)])


def test_ring_modes_give_bit_identical_grads(smoke):
    """Modes change the order of the hop and the consume, never values:
    the loss and every gradient agree bit for bit across sw, xqueue and
    qlr (the readers' gradients are added in one order)."""
    _, cfg, _, _, tree = smoke
    batch = _torch_batch(_batch(cfg.vocab_size))
    runs = {}
    for mode in ("qlr", "xqueue", "sw"):
        mcfg = replace(cfg, systolic_mode=mode)
        loss, _, grads = step_lib.value_and_grad(
            build_model(mcfg, n_pe=2), params_from_reference(tree, mcfg,
                                                             "cpu"), batch)
        runs[mode] = [loss] + opt.tree_leaves(grads)
    for mode in ("xqueue", "sw"):
        assert all(torch.equal(a, b) for a, b in zip(runs[mode],
                                                     runs["qlr"])), mode


def test_training_after_serving_under_inference_mode(smoke):
    """The ring's cached index tables, first built while serving under
    ``torch.inference_mode``, also serve a later training step (autograd
    cannot save an inference tensor for backward)."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import queues
    _, cfg, _, _, tree = smoke
    for table in (queues._pred_index, cm._source_table, cm._dest_table):
        table.cache_clear()
    cfg = replace(cfg, systolic_mode="qlr")
    model = build_model(cfg, n_pe=2)
    params = params_from_reference(tree, cfg, "cpu")
    batch = _torch_batch(_batch(cfg.vocab_size))
    with torch.inference_mode():
        model.prefill(params, batch["tokens"])
    loss, _, grads = step_lib.value_and_grad(model, params, batch)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in opt.tree_leaves(grads))
