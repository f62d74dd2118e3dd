"""The rest of the port's single-device layer, and the dense configs that
need nothing more (olmo-1b, qwen3-14b, granite-34b), against the reference.

Inputs come from numpy seeds and go through both packages. Bounds:

- ``layernorm``, ``nonparam_ln``, the GELU MLP and ``sinusoidal_positions``
  in fp32: 1e-5 relative to the largest value (the same elementwise
  formulas; the MLP's two products sum in another order). In bf16 the
  norms round once at the end in both packages: one bf16 ulp, 2^-7;
- SMOKE models in fp32 with the reference's own weights: prefill and
  decode logits 2e-3 (``tests/test_parity.py``), the loss 1e-4 and every
  gradient 1e-3 (``tests/test_torch_train.py``), dense and on a ring of 2
  in each link mode, through the kernel wrappers' CPU twins.

olmo-1b's norms have no parameters (empty dicts in both packages);
granite-34b is MQA, so the QKV ring is refused and ring attention runs a
GQA group of 4 at SMOKE width (48 at full width).
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

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core import collective_matmul as cm
from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
    state_from_reference,
    state_to_reference,
)
from repro_torch.models import common
from repro_torch.models.convert import _first_leaf
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARCHS = ("olmo-1b", "qwen3-14b", "granite-34b")
RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(2, "xqueue", id="ring2-xqueue")]
TOL = 2e-3
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3
B, S = 2, 16


def _close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["layernorm", "nonparam_ln", "rmsnorm"])
def test_norms_vs_reference(ref, norm, dtype):
    from repro.configs.base import ModelConfig as RConfig
    from repro.models.common import apply_norm as r_norm
    from repro_torch.configs.base import ModelConfig
    rng = np.random.default_rng(0)
    d = 48
    x = (rng.standard_normal((3, 5, d)) * 2 + 0.7).astype(np.float32)
    tree = {"scale": 1 + 0.1 * rng.standard_normal(d).astype(np.float32),
            "bias": 0.1 * rng.standard_normal(d).astype(np.float32)}
    keys = {"layernorm": ("scale", "bias"), "nonparam_ln": (),
            "rmsnorm": ("scale",)}[norm]
    tree = {k: tree[k] for k in keys}
    fields = dict(d_model=d, norm_type=norm, dtype=dtype, param_dtype=dtype)
    cfg, rcfg = ModelConfig(**fields), RConfig(**fields)
    init = common.init_norm(torch.Generator().manual_seed(0), cfg)
    assert sorted(init) == sorted(keys)
    tdt = common.adtype(cfg)
    params = {k: torch.as_tensor(v).to(tdt) for k, v in tree.items()}
    got = common.apply_norm(params, torch.as_tensor(x).to(tdt), cfg)
    jdt = jnp.dtype(dtype)
    want = r_norm({k: jnp.asarray(v).astype(jdt) for k, v in tree.items()},
                  jnp.asarray(x).astype(jdt), rcfg)
    assert got.dtype == tdt
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_layernorm_is_population_variance():
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(d_model=2, norm_type="nonparam_ln", dtype="float32")
    got = common.apply_norm({}, torch.tensor([[1.0, 3.0]]), cfg, eps=1e-12)
    torch.testing.assert_close(got, torch.tensor([[-1.0, 1.0]]))


def test_gelu_mlp_vs_reference(ref):
    from repro.configs.base import ModelConfig as RConfig
    from repro.models.common import apply_mlp as r_mlp
    from repro.models.common import init_mlp as r_init
    from repro.models.common import split_tree
    from repro_torch.configs.base import ModelConfig
    fields = dict(d_model=32, d_ff=96, mlp_kind="gelu", dtype="float32",
                  param_dtype="float32")
    cfg, rcfg = ModelConfig(**fields), RConfig(**fields)
    rparams, _ = split_tree(r_init(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(1)
    # biases are zeros at init: draw them, so that they count
    tree = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                                if k.startswith("b_") else 0.0)
            for k, v in rparams.items()}
    init = common.init_mlp(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in tree.items()}
    x = (rng.standard_normal((2, 7, 32)) * 3).astype(np.float32)
    got = common.apply_mlp({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in tree.items()}, torch.as_tensor(x),
                           cfg)
    want = r_mlp({k: jnp.asarray(v, jnp.float32) for k, v in tree.items()},
                 jnp.asarray(x), rcfg)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("num_pos,d", [(1, 2), (7, 16), (1500, 384)])
def test_sinusoidal_positions_vs_reference(ref, num_pos, d):
    """The angles pos * exp(-c i) are fp32 products as large as num_pos:
    one ulp of exp's result in either package moves an angle by up to
    num_pos * 2^-23, and sin/cos by as much."""
    from repro.models.common import sinusoidal_positions as r_sin
    got = common.sinusoidal_positions(num_pos, d, "cpu")
    assert got.shape == (num_pos, d) and got.dtype == torch.float32
    _close(got, r_sin(num_pos, d), max(1e-5, 2 * num_pos * 2.0 ** -23))


def test_gelu_mlp_stays_off_the_ring():
    """A GELU MLP never takes the systolic SwiGLU, as in the reference."""
    from repro_torch.models.transformer import _maybe_systolic_mlp
    cfg = replace(get_smoke_config("qwen3-14b"), mlp_kind="gelu",
                  systolic_mode="qlr", dtype="float32",
                  param_dtype="float32")
    lp = common.init_mlp(torch.Generator().manual_seed(0), cfg)
    h = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    torch.testing.assert_close(_maybe_systolic_mlp(lp, h, cfg, 2),
                               common.apply_mlp(lp, h, cfg), rtol=0, atol=0)


def test_first_leaf_skips_empty_norms():
    a = np.zeros((3, 2))
    assert _first_leaf({"norm1": {}, "attn": {"wq": a}}) is a
    assert _first_leaf({"norm1": {}, "norm2": {}}) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(ref, arch):
    import dataclasses
    from repro.configs import get_config as r_config
    from repro.configs import get_smoke_config as r_smoke
    for mine, theirs in ((get_config(arch), r_config(arch)),
                         (get_smoke_config(arch), r_smoke(arch))):
        for f in dataclasses.fields(mine):
            if f.name in PORT_FIELDS:      # the port's own, at its default
                assert getattr(mine, f.name) == f.default, f.name
                continue
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


# ---------------------------------------------------------------------------
# the dense configs at SMOKE size
# ---------------------------------------------------------------------------


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": raw[:, :-1], "targets": raw[:, 1:],
            "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


@pytest.fixture(scope="module", params=ARCHS)
def smoke(ref, request):
    arch = request.param
    rcfg, cfg = smoke_fp32(arch)
    rmodel, rparams, tree = reference_model(rcfg, seed=2)
    batch = _batch(cfg.vocab_size)
    (loss, aux), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, jax.tree_util.tree_map(jnp.asarray, batch))
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rmodel=rmodel,
                rparams=rparams, tree=tree, batch=batch, loss=float(loss),
                ce=float(aux["ce"]), grads=grads)


def _port(sm, n_pe, mode, **overrides):
    cfg = replace(sm["cfg"], systolic_mode=mode, **overrides)
    return build_model(cfg, n_pe=n_pe), params_from_reference(
        sm["tree"], cfg, "cpu")


def test_params_round_trip(smoke):
    """Every leaf survives the round trip; olmo's empty norms stay empty
    dicts in both layouts."""
    tree = smoke["tree"]
    params = params_from_reference(tree, smoke["cfg"], "cpu")
    back = params_to_reference(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    if smoke["arch"] == "olmo-1b":
        assert params["layers"][0]["norm1"] == {} == back["layers"]["norm1"]
        assert params["final_norm"] == {} == back["final_norm"]


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_vs_reference(smoke, n_pe, mode):
    tokens = np.random.default_rng(1).integers(
        0, smoke["cfg"].vocab_size, (2, 8)).astype(np.int32)
    want = jax.jit(smoke["rmodel"].prefill)(
        smoke["rparams"], {"tokens": jnp.asarray(tokens)})
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    _close(got, want, TOL)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_into_cache_then_decode_vs_reference(smoke, n_pe, mode):
    """Block prefill into one slot, then decode steps with a row masked
    off: logits and the cache match the reference step for step."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    vocab = smoke["cfg"].vocab_size
    rng = np.random.default_rng(2)
    b, s, c, length = 4, 16, 8, 5
    chunk = rng.integers(0, vocab, c).astype(np.int32)
    r_logit, rcache = jax.jit(rmodel.prefill_into_cache)(
        rparams, rmodel.init_cache(b, s), jnp.asarray(chunk), jnp.int32(1),
        jnp.int32(length))
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        logit, cache = model.prefill_into_cache(
            params, model.init_cache(b, s, "cpu"), torch.as_tensor(chunk), 1,
            length)
    _close(logit, r_logit, TOL)
    step = jax.jit(rmodel.decode_step)
    active = np.array([True, True, False, True])
    for _ in range(3):
        toks = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        _close(logits, r_logits, TOL)
    for name in ("k", "v", "pos"):
        _close(cache["layers"][name], rcache["layers"][name], TOL)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_loss_and_grads_vs_reference(smoke, n_pe, mode):
    model, params = _port(smoke, n_pe, mode)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    assert float(metrics["ce"]) == pytest.approx(smoke["ce"], abs=LOSS_TOL)
    got, want = _leaves(params_to_reference(grads)), _leaves(smoke["grads"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


def test_rings_engage_as_the_reference_gates(smoke):
    """Which rings run: granite's single KV head refuses the QKV ring;
    the others take it on a ring of 2. Ring attention takes them all."""
    cfg = smoke["cfg"]
    x = torch.zeros(B, S, cfg.d_model)
    qkv = cm.attn_applicable(x, cfg.num_heads, cfg.num_kv_heads,
                             cfg.resolved_head_dim, 2)
    assert qkv == (smoke["arch"] != "granite-34b")
    assert cm.ffn_applicable(x, cfg.d_ff, 2)


# ---------------------------------------------------------------------------
# checkpoints with empty norm dicts, both ways
# ---------------------------------------------------------------------------


def _keyed(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {k: v for key, sub in items
            for k, v in _keyed(sub, f"{prefix}/{key}").items()}


def test_olmo_state_and_checkpoint_round_trip(ref, tmp_path):
    """olmo's train state (bf16 parameters, fp32 moments and masters)
    through ``state_to_reference``/``state_from_reference`` and through a
    checkpoint written by the port and restored by the reference, and
    back: empty norm dicts survive each hop."""
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    from repro.train.checkpoint import CheckpointManager as RManager
    cfg, tcfg = get_smoke_config("olmo-1b"), TrainConfig()
    state = step_lib.init_state(cfg, tcfg, 3, "cpu")
    assert state["opt"]["m"]["layers"][1]["norm2"] == {}
    back = state_from_reference(state_to_reference(state), cfg, tcfg, "cpu")
    a, b = _keyed(state), _keyed(back)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
               for k in a)
    ckpt_lib.CheckpointManager(str(tmp_path), async_save=False).save(
        4, state)
    target = rstep.init_state(r_smoke("olmo-1b"), tcfg,
                              jax.random.PRNGKey(0))
    got = RManager(str(tmp_path), async_save=False).restore(4, target)
    want = _leaves(state_to_reference(state))
    assert _leaves(got).keys() == want.keys()
    for k, v in _leaves(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    RManager(str(tmp_path / "ref"), async_save=False).save(5, got)
    mine = ckpt_lib.CheckpointManager(str(tmp_path / "ref"),
                                      async_save=False)
    restored = mine.restore(5, step_lib.init_state(cfg, tcfg, 9, "cpu"))
    a, b = _keyed(restored), _keyed(state)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_olmo_optimizer_carries_empty_norms():
    cfg = replace(get_smoke_config("olmo-1b"), dtype="float32",
                  param_dtype="float32")
    tcfg = TrainConfig(warmup_steps=0, learning_rate=1e-2)
    state = step_lib.init_state(cfg, tcfg, 0, "cpu")
    train = step_lib.make_train_step(cfg, tcfg)
    raw = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.as_tensor(raw[:, :-1]),
             "targets": torch.as_tensor(raw[:, 1:])}
    new, metrics = train(state, batch)
    assert new["params"]["layers"][0]["norm1"] == {}
    assert new["opt"]["v"]["final_norm"] == {}
    assert len(opt.tree_leaves(new)) == len(opt.tree_leaves(state))
    assert np.isfinite(float(metrics["loss"]))
