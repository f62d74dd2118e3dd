"""The port's MoE family against the reference: routing, capacity ranks,
the dense dispatch, the expert ring per PE, and mixtral SMOKE end to end.

Sizes are those of ``tests/test_moe_dispatch.py`` and
``tests/multidev/check_ring_moe.py`` (d_model 16, 8 experts top-2,
capacity factor 2; the overflow case 4 experts at capacity factor 0.5).
The reference's shard_map-local ``ring_moe`` runs per PE under
``jax.vmap(..., axis_name="model")``, as ``tests/test_torch_ring.py``
runs the other ring ops. Bounds: 1e-5 in fp32 for the dense path and the
per-PE ring, 1e-4 / 1e-3 for the ring against the dense path (values /
gradients, ``check_ring_moe.py``), 2e-3 for model logits
(``tests/test_parity.py``), loss 1e-4 and gradients 1e-3 against
``jax.value_and_grad`` (``check_systolic_model.py``).

Routing ranks experts by probability; exact ties go to the lower index
in both packages (the port sorts stably). Random weights make ties
vanishingly rare; the zero-router case below makes every token a tie on
purpose.
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
    to_torch,
)
from test_torch_serve import _drive, assert_lockstep

from repro_torch.configs import ServeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring_moe as rm
from repro_torch.core import topology as tp
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.models import (
    build_model,
    moe,
    params_from_reference,
    params_to_reference,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend
from repro_torch.train import step as step_lib

TOL = 1e-5
MODES = ("baseline", "sw", "xqueue", "qlr")
FP32 = dict(dtype="float32", param_dtype="float32")
CFG = dict(name="ring-moe-check", family="moe", d_model=16, d_ff=32,
           d_ff_expert=32, num_experts=8, experts_per_token=2,
           capacity_factor=2.0, **FP32)
OVERFLOW = dict(CFG, name="ring-moe-overflow", num_experts=4,
                capacity_factor=0.5)


def _cfgs(**kw):
    """(reference ModelConfig, the port's) of the same fields."""
    from repro.configs.base import ModelConfig as RModelConfig
    return RModelConfig(**kw), ModelConfig(**kw)


def _moe_params(rcfg, seed):
    """The reference's MoE parameters: (jax tree, the port's tensors)."""
    from repro.models import moe as rmoe
    from repro.models.common import split_tree
    params, _ = split_tree(rmoe.init_moe(jax.random.PRNGKey(seed), rcfg))
    port = jax.tree_util.tree_map(lambda a: to_torch(a), params)
    return params, port


def _ref_apply(params, x, rcfg):
    """The reference's ``apply_moe``, jitted (faster than op by op)."""
    from repro.models import moe as rmoe
    return jax.jit(rmoe.apply_moe, static_argnums=2)(params, x, rcfg)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# routing, ranks, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [CFG, OVERFLOW], ids=["plain", "overflow"])
@pytest.mark.parametrize("seq", [1, 16, 64, 1024, 4096])
def test_expert_capacity_matches_reference(ref, fields, seq):
    from repro.models import moe as rmoe
    rcfg, cfg = _cfgs(**fields)
    assert moe.expert_capacity(cfg, seq) == rmoe.expert_capacity(rcfg, seq)


@pytest.mark.parametrize("fields", [CFG, OVERFLOW], ids=["plain", "overflow"])
def test_routing_ranks_and_dispatch_match_reference(ref, fields):
    from repro.models import moe as rmoe
    rcfg, cfg = _cfgs(**fields)
    e = cfg.num_experts
    logits = np.random.default_rng(0).standard_normal((2, 64, e)) \
        .astype(np.float32)
    rw, ridx, raux = rmoe._topk_routing(jnp.asarray(logits), rcfg)
    w, idx, aux = moe._topk_routing(to_torch(logits), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(w, rw)
    assert float(aux) == pytest.approx(float(raux), rel=1e-6)
    rpos = rmoe._positions_in_expert(ridx, e)
    pos = moe._positions_in_expert(idx, e)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    cap = moe.expert_capacity(cfg, 64)
    np.testing.assert_array_equal(
        moe._dispatch_indices(idx, pos, e, cap).numpy(),
        np.asarray(rmoe._dispatch_indices(ridx, rpos, e, cap)))
    if fields is OVERFLOW:
        assert int((pos >= cap).sum()) > 0, "the case must overflow"


def test_positions_form_valid_arrival_order():
    """Per (row, expert) the ranks in arrival priority (k-slot, then
    token) are exactly 0, 1, 2, ..."""
    b, s, k, e = 2, 17, 3, 5
    idx = torch.randint(0, e, (b, s, k), generator=torch.Generator()
                        .manual_seed(0))
    pos = moe._positions_in_expert(idx, e)
    for bi in range(b):
        for ei in range(e):
            ranks = [int(pos[bi, si, ki]) for ki in range(k)
                     for si in range(s) if idx[bi, si, ki] == ei]
            assert ranks == list(range(len(ranks)))


def test_zero_router_ties_and_overflow_like_reference(ref):
    """A zero router makes every token an exact tie: both packages route
    it to expert 0 (the lower index), so tokens past the capacity drop."""
    rcfg, cfg = _cfgs(**dict(CFG, num_experts=4, experts_per_token=1,
                             capacity_factor=1.0))
    rparams, params = _moe_params(rcfg, 0)
    rparams["router"] = jnp.zeros_like(rparams["router"])
    params["router"] = torch.zeros_like(params["router"])
    x = np.random.default_rng(1).standard_normal((2, 64, 16)) \
        .astype(np.float32)
    want, _ = _ref_apply(rparams, jnp.asarray(x), rcfg)
    got, _ = moe.apply_moe(params, to_torch(x), cfg)
    _close(got, want)
    cap = moe.expert_capacity(cfg, 64)
    assert float(got[:, cap:].abs().max()) == 0.0


@pytest.mark.parametrize("variant", [
    pytest.param({}, id="plain"),
    pytest.param(dict(moe_subexperts=2), id="subexperts"),
    pytest.param(dict(num_shared_experts=1), id="shared"),
    pytest.param(OVERFLOW, id="overflow")])
def test_apply_moe_dense_vs_reference(ref, variant):
    rcfg, cfg = _cfgs(**dict(CFG, **variant))
    rparams, params = _moe_params(rcfg, 2)
    x = np.random.default_rng(3).standard_normal((2, 32, 16)) \
        .astype(np.float32)
    want, waux = _ref_apply(rparams, jnp.asarray(x), rcfg)
    got, aux = moe.apply_moe(params, to_torch(x), cfg)
    _close(got, want)
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)


# ---------------------------------------------------------------------------
# the expert ring
# ---------------------------------------------------------------------------


def _routing(cfg, params, x):
    logits = torch.einsum("bsd,de->bse", x, params["router"])
    w, idx, _ = moe._topk_routing(logits, cfg)
    return w, idx, moe._positions_in_expert(idx, cfg.num_experts)


@pytest.mark.parametrize("name", ["ring", "snake_fold", "torus2d",
                                  "cannon_grid"])
@pytest.mark.parametrize("mode", MODES)
def test_ring_moe_per_pe(ref, name, mode):
    """The reference's per-device ``ring_moe`` under vmap against the
    port's, every PE at once, on each schedule of 4 PEs."""
    from repro.core import ring_moe as rrm
    from repro.core import topology as rtp
    rcfg, cfg = _cfgs(**CFG)
    _, params = _moe_params(rcfg, 0)
    x = to_torch(np.random.default_rng(1).standard_normal((2, 32, 16)))
    w, idx, pos = _routing(cfg, params, x)
    n, cap = 4, moe.expert_capacity(cfg, 32)

    def blocks(t):                      # [B, S, ...] -> [n, B, S/n, ...]
        return t.reshape(2, n, 8, *t.shape[2:]).transpose(0, 1)

    def per_pe(wt):                     # [E, ...] -> [n, E/n, ...]
        return wt.reshape(n, -1, *wt.shape[1:])

    args = [blocks(x), blocks(idx), blocks(pos), blocks(w)]
    weights = [params[k] for k in ("w_gate", "w_up", "w_down")]
    rtopo = rtp.resolve(name, "model", n)
    want = jax.jit(jax.vmap(lambda a, b, c, d, e, f, g: rrm.ring_moe(
        a, b, c, d, e, f, g, rtopo, cap, mode), axis_name="model"))(
        *(jnp.asarray(t.numpy()) for t in args + [per_pe(t) for t in
                                                   weights]))
    got = rm.ring_moe(*args, *weights, tp.resolve(name, "model", n), cap,
                      mode)
    _close(got, want)


@pytest.mark.parametrize("fields", [CFG, OVERFLOW], ids=["plain", "overflow"])
def test_systolic_ring_moe_vs_dense_values_and_grads(ref, fields):
    """Every mode against the dense dispatch: values 1e-4, gradients of
    sum(y**2) + aux in the parameters and x 1e-3 (the reference's
    ``check_ring_moe.py`` bounds); the modes' gradients bit for bit."""
    rcfg, cfg = _cfgs(**fields)
    _, params = _moe_params(rcfg, 2)
    s = 64 if fields is OVERFLOW else 32
    x = to_torch(np.random.default_rng(3).standard_normal((2, s, 16)))

    def run(mode, n_pe):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        xi = x.detach().requires_grad_(True)
        y, aux = moe.apply_moe(p, xi, replace(cfg, systolic_mode=mode),
                               n_pe)
        grads = torch.autograd.grad((y ** 2).sum() + aux,
                                    [xi, *p.values()])
        return y.detach(), grads

    y_ref, g_ref = run("baseline", 0)
    runs = {}
    for mode in ("sw", "xqueue", "qlr"):
        y, grads = runs[mode] = run(mode, 4)
        _close(y, y_ref.numpy(), 1e-4)
        for g, w in zip(grads, g_ref):
            _close(g, w.numpy(), 1e-3)
    for mode in ("sw", "xqueue"):
        assert all(torch.equal(a, b) for a, b in
                   zip(runs[mode][1], runs["qlr"][1]))


def test_ring_moe_applicable_gate(ref):
    rcfg, cfg = _cfgs(**CFG)
    x = torch.zeros(2, 32, 16)
    assert rm.ring_moe_applicable(cfg, x, 4)
    assert not rm.ring_moe_applicable(cfg, x, 1)
    assert not rm.ring_moe_applicable(replace(cfg, moe_subexperts=2), x, 4)
    assert not rm.ring_moe_applicable(replace(cfg, num_shared_experts=1), x,
                                      4)
    assert not rm.ring_moe_applicable(replace(cfg, num_experts=6), x, 4)
    assert not rm.ring_moe_applicable(cfg, x[:, :30], 4)


@pytest.fixture
def mm_launches(monkeypatch):
    """Count the tile-matmul twin's calls (one per kernel launch on the
    card)."""
    plain = mk.matmul_plain
    count = [0]

    def counted(*args, **kw):
        count[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(mk, "matmul_plain", counted)
    return count


@pytest.mark.parametrize("mode", MODES)
def test_tile_matmul_launches_per_moe_layer(mm_launches, mode):
    """The expert FFN is three tile-matmul launches over all experts,
    whatever the mode; the dense dispatch launches none."""
    cfg = replace(ModelConfig(**CFG), systolic_mode=mode)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 32, 16, generator=torch.Generator().manual_seed(1))
    moe.apply_moe(params, x, cfg, n_pe=4)
    assert mm_launches[0] == (0 if mode == "baseline" else 3)
    mm_launches[0] = 0
    w, idx, pos = _routing(cfg, params, x)
    rm.systolic_ring_moe(x, idx, pos, w, params["w_gate"], params["w_up"],
                         params["w_down"], 16, 4, mode)
    assert mm_launches[0] == 3


# ---------------------------------------------------------------------------
# mixtral SMOKE end to end
# ---------------------------------------------------------------------------

RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(4, "sw", id="ring4-sw")]
SEQ = 24                # past the SMOKE window of 16


@pytest.fixture(scope="module")
def mixtral(ref):
    rcfg, cfg = smoke_fp32("mixtral-8x22b")
    rmodel, rparams, tree = reference_model(rcfg)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits = np.asarray(jax.jit(rmodel.prefill)(
        rparams, {"tokens": jnp.asarray(batch["tokens"])}))
    return cfg, tree, batch, logits, float(loss), float(aux["aux"]), grads


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_mixtral_prefill_vs_reference(mixtral, n_pe, mode):
    cfg, tree, batch, want, *_ = mixtral
    cfg = replace(cfg, systolic_mode=mode)
    model = build_model(cfg, n_pe=n_pe)
    params = params_from_reference(tree, cfg, "cpu")
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(batch["tokens"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_mixtral_loss_and_grads_vs_reference(mixtral, n_pe, mode):
    """The loss (CE plus the router's aux), its aux, and every gradient
    against ``jax.value_and_grad`` of the reference's loss."""
    from test_torch_train import _assert_trees_close
    cfg, tree, batch, _, want_loss, want_aux, want_grads = mixtral
    cfg = replace(cfg, systolic_mode=mode)
    model = build_model(cfg, n_pe=n_pe)
    params = params_from_reference(tree, cfg, "cpu")
    loss, metrics, grads = step_lib.value_and_grad(
        model, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(want_loss, abs=1e-4)
    assert float(metrics["aux"]) == pytest.approx(want_aux, rel=1e-5)
    assert float(metrics["aux"]) > 0
    _assert_trees_close(params_to_reference(grads), want_grads, rtol=1e-3,
                        atol=1e-3)


def test_mixtral_prefill_vs_streamed_decode(mixtral):
    """Prefill logits equal the last of SEQ streamed decode steps (the
    window bites at 16), within 2e-3."""
    cfg, tree, batch, *_ = mixtral
    model = build_model(cfg)
    params = params_from_reference(tree, cfg, "cpu")
    tokens = torch.as_tensor(batch["tokens"])
    with torch.no_grad():
        want = model.prefill(params, tokens)
        cache = model.init_cache(2, SEQ, "cpu")
        for t in range(SEQ):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mixtral_params_round_trip_router_fp32(ref):
    """bf16 SMOKE parameters through the port and back: every leaf exact,
    the router fp32 under bf16 as in the reference; first_k_dense layers
    go to and from ``dense_layers``."""
    from repro.configs import get_smoke_config as r_smoke
    from repro_torch.configs import get_smoke_config
    for extra in ({}, dict(num_layers=3, first_k_dense=1, d_ff_dense=48)):
        rcfg = replace(r_smoke("mixtral-8x22b"), **extra)
        cfg = replace(get_smoke_config("mixtral-8x22b"), **extra)
        _, _, tree = reference_model(rcfg)
        params = params_from_reference(tree, cfg, "cpu")
        assert len(params["layers"]) == cfg.num_layers
        assert params["layers"][-1]["moe"]["router"].dtype == torch.float32
        assert params["layers"][-1]["moe"]["w_gate"].dtype == torch.bfloat16
        back = params_to_reference(params)
        flat = dict(jax.tree_util.tree_leaves_with_path(back))
        for path, a in jax.tree_util.tree_leaves_with_path(tree):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          flat[path])
        own = build_model(cfg).init(0, "cpu")
        assert jax.tree_util.tree_structure(params_to_reference(own)) == \
            jax.tree_util.tree_structure(back)


def test_first_k_dense_prefill_vs_reference(ref):
    """A leading dense layer at d_ff_dense before the MoE layers."""
    from repro.configs import get_smoke_config as r_smoke
    extra = dict(num_layers=3, first_k_dense=1, d_ff_dense=48)
    rcfg, cfg = smoke_fp32("mixtral-8x22b")
    rcfg, cfg = replace(rcfg, **extra), replace(cfg, **extra)
    assert r_smoke("mixtral-8x22b").first_k_dense == 0
    rmodel, rparams, tree = reference_model(rcfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 8))
    want = np.asarray(jax.jit(rmodel.prefill)(
        rparams, {"tokens": jnp.asarray(tokens)}))
    model = build_model(replace(cfg, systolic_mode="qlr"), n_pe=2)
    params = params_from_reference(tree, cfg, "cpu")
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]
    assert params["layers"][0]["mlp"]["w_gate"].shape[-1] == 48
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


SCFG = dict(max_batch=4, max_seq_len=32, temperature=0.0, prefill_chunk=8)


def _schedule(vocab):
    """[(tick, prompt, max_new)]: prompts past the window of 16 stream."""
    rng = np.random.default_rng(0)
    return [(tick, rng.integers(0, vocab, int(rng.integers(2, 20)))
             .astype(np.int32), int(rng.integers(3, 7)))
            for tick in (0, 0, 0, 0, 5, 9)]


@pytest.fixture(scope="module")
def mixtral_serving(ref):
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.engine import ServeEngine as RServeEngine
    rcfg, cfg = smoke_fp32("mixtral-8x22b")
    _, rparams, tree = reference_model(rcfg)
    engine = RServeEngine(rcfg, RServeConfig(**SCFG), rparams)
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: np.asarray(x, np.float32))
    return cfg, tree, record


@pytest.mark.parametrize("n_pe,mode", [(0, "dense"), (2, "qlr")])
def test_mixtral_greedy_serving_vs_reference_engine(mixtral_serving, n_pe,
                                                    mode):
    """The reference's engine and the port's in lockstep: the sliding
    window keeps both from block prefill, so prompts stream through the
    decode step."""
    cfg, tree, ref_record = mixtral_serving
    scfg = ServeConfig(**SCFG)
    params = params_from_reference(tree, cfg, device="cpu")
    backend = RingShardedBackend(cfg, scfg, params, n_pe, mode,
                                 device="cpu") if n_pe else \
        DecodeBackend(cfg, scfg, params, device="cpu")
    assert backend.prefill_len(12) == 0
    engine = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: x.numpy().astype(np.float32),
                    commit_tokens=[r[2] for r in ref_record])
    assert_lockstep(record, ref_record)


def test_first_k_dense_train_state_and_checkpoint_both_ways(ref, tmp_path):
    """A reference train state of an MoE model with a leading dense layer
    (``dense_layers`` beside ``layers``) restores from the reference's
    checkpoint into the port, equals ``state_from_reference``, and goes
    back through ``state_to_reference`` leaf for leaf."""
    from test_torch_train import _assert_states_equal
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    from repro.train.checkpoint import CheckpointManager as RManager
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.models import state_from_reference, state_to_reference
    from repro_torch.train import checkpoint as ckpt_lib
    extra = dict(num_layers=3, first_k_dense=1, d_ff_dense=48)
    rcfg = replace(r_smoke("mixtral-8x22b"), **extra)
    cfg = replace(get_smoke_config("mixtral-8x22b"), **extra)
    tcfg = TrainConfig()
    rstate = rstep.init_state(rcfg, tcfg, jax.random.PRNGKey(7))
    RManager(str(tmp_path), async_save=False).save(3, rstate)
    tree = jax.tree_util.tree_map(np.asarray, rstate)
    want = state_from_reference(tree, cfg, tcfg, "cpu")
    assert "mlp" in want["params"]["layers"][0]
    assert want["opt"]["m"]["layers"][1]["moe"]["router"].dtype == \
        torch.float32
    got = ckpt_lib.CheckpointManager(str(tmp_path), async_save=False) \
        .restore(3, step_lib.init_state(cfg, tcfg, 0, "cpu"))
    _assert_states_equal(got, want)
    back = dict(jax.tree_util.tree_leaves_with_path(state_to_reference(got)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(np.asarray(a, np.float32)
                                      if a.dtype != np.int32 else a,
                                      back[path])
