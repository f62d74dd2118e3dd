"""The port's Whisper encoder-decoder (whisper-tiny) against the reference,
on the CPU.

SMOKE whisper-tiny in fp32 with the reference's weights (biases and norm
parameters drawn, so they count): 2 encoder and 2 decoder layers, 4 heads
(MHA) of 16, 32 frames, LayerNorm, the GELU MLP, no RoPE, learned decoder
positions (64) and an untied head. Inputs come from numpy seeds. Bounds:

- ``sinusoidal_positions``, ``cross_kv`` and ``cross_attend``: 1e-5 of
  the largest value (the same fp32 formulas);
- ``encode``, ``decode_stack`` and prefill logits: 1e-4 of their scale,
  dense and on rings of 2 (the QKV ring in the encoder and the decoder,
  ring attention in the decoder) in each link mode and of 4; the modes
  bit for bit;
- the loss 1e-4 and every gradient 1e-3 (``tests/test_torch_train.py``);
- ``fill_cross_cache`` and ``decode_step`` against the reference, and the
  port's prefill against its own streamed decode
  (``tests/test_parity.py::test_whisper_prefill_decode_parity``): 2e-3;
- bf16 prefill against the reference's bf16 prefill: 2e-2.
"""
from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import (  # noqa: F401 (fixture)
    perturbed,
    ref,
    reference_model,
    smoke_fp32,
)

from repro_torch.configs import (
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
    state_from_reference,
    state_to_reference,
)
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.serve.sharded_cache import DecodeBackend
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARCH = "whisper-tiny"
RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(2, "xqueue", id="ring2-xqueue"),
         pytest.param(4, "qlr", id="ring4-qlr")]
LAYER_TOL, LOGIT_TOL, DECODE_TOL, BF16_TOL = 1e-5, 1e-4, 2e-3, 2e-2
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


def _batch(cfg, s=S, seed=3):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    return {"tokens": raw[:, :-1], "targets": raw[:, 1:],
            "mask": (rng.random((B, s)) > 0.25).astype(np.float32),
            "frames": rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def _jnp(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if keys is None or k in keys}


def _torch(batch, keys=None):
    return {k: torch.as_tensor(v) for k, v in batch.items()
            if keys is None or k in keys}


@pytest.fixture(scope="module")
def smoke(ref):
    rcfg, cfg = smoke_fp32(ARCH)
    rmodel, _, tree = reference_model(rcfg, seed=2)
    tree = perturbed(tree, seed=4)
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _batch(cfg)
    (loss, _), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, _jnp(batch))
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams,
                tree=tree, batch=batch, loss=float(loss), grads=grads)


def _port(sm, n_pe=0, mode="baseline", **overrides):
    cfg = replace(sm["cfg"], systolic_mode=mode, **overrides)
    return build_model(cfg, n_pe=n_pe), params_from_reference(
        sm["tree"], cfg, "cpu")


@pytest.fixture
def launches(monkeypatch):
    """Count the twins' calls through the kernel wrappers (one per kernel
    launch on the card)."""
    count = {"tile_matmul": 0, "flash_carry": 0}
    for mod, attr, name in ((mk, "matmul_plain", "tile_matmul"),
                            (fk, "flash_carry_plain", "flash_carry")):
        plain = getattr(mod, attr)

        def counted(*a, _plain=plain, _name=name, **kw):
            count[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return count


# ---------------------------------------------------------------------------
# config, parameters, train state
# ---------------------------------------------------------------------------


def test_configs_match_reference(ref):
    from repro.configs import get_config as r_config
    from repro.configs import get_smoke_config as r_smoke
    for mine, theirs in ((get_config(ARCH), r_config(ARCH)),
                         (get_smoke_config(ARCH), r_smoke(ARCH))):
        for f in fields(mine):
            if f.name in PORT_FIELDS:      # the port's own, at its default
                assert getattr(mine, f.name) == f.default, f.name
                continue
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


def test_params_round_trip(smoke):
    """``enc_layers`` and ``dec_layers`` become two lists; ``embed``, the
    untied ``head``, ``enc_norm``, ``dec_norm`` and ``dec_pos`` stay
    unstacked; all come back exactly."""
    tree = smoke["tree"]
    cfg = smoke["cfg"]
    params = params_from_reference(tree, cfg, "cpu")
    assert len(params["enc_layers"]) == cfg.enc_layers
    assert len(params["dec_layers"]) == cfg.num_layers
    assert set(params["dec_layers"][0]["cross_attn"]) == {
        "wq", "wk", "wv", "wo", "bq"}
    assert "final_norm" not in params
    back = params_to_reference(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    own = params_to_reference(build_model(cfg).init(0, "cpu"))
    assert jax.tree_util.tree_map(np.shape, own) == \
        jax.tree_util.tree_map(np.shape, tree)


def test_train_state_round_trip(ref):
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    tcfg = TrainConfig()
    rstate = rstep.init_state(r_smoke(ARCH), tcfg, jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, rstate)
    state = state_from_reference(tree, get_smoke_config(ARCH), tcfg, "cpu")
    assert state["params"]["dec_pos"].dtype == torch.bfloat16
    assert state["opt"]["v"]["enc_layers"][1]["mlp"]["b_up"].dtype == \
        torch.float32
    back = dict(jax.tree_util.tree_leaves_with_path(state_to_reference(state)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            np.asarray(a, np.float32) if a.dtype != np.int32 else a,
            back[path])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_sinusoidal_positions_at_the_encoder_shape(ref, smoke):
    """The encoder's table, on the device the caller names, equals the
    reference's; without a device it asks for the card."""
    from repro.models.common import sinusoidal_positions as r_sin
    cfg = smoke["cfg"]
    got = common.sinusoidal_positions(cfg.enc_frames, cfg.d_model,
                                      torch.device("cpu"))
    _close(got, r_sin(cfg.enc_frames, cfg.d_model), LAYER_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            common.sinusoidal_positions(cfg.enc_frames, cfg.d_model)


def _cross_params(sm, layer=1):
    leaves = {k: np.array(v[layer]) for k, v in
              sm["tree"]["dec_layers"]["cross_attn"].items()}
    return leaves, {k: torch.as_tensor(v) for k, v in leaves.items()}


def test_cross_kv_and_attend_vs_reference(smoke):
    from repro.models import attention as rattn
    rcfg, cfg = smoke["rcfg"], smoke["cfg"]
    leaves, tp = _cross_params(smoke)
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    rk, rv = rattn.cross_kv(leaves, jnp.asarray(memory), rcfg)
    k, v = attn.cross_kv(tp, torch.as_tensor(memory), cfg)
    _close(k, rk, LAYER_TOL)
    _close(v, rv, LAYER_TOL)
    want = rattn.cross_attend(leaves, jnp.asarray(x), rk, rv, rcfg)
    got = attn.cross_attend(tp, torch.as_tensor(x), k, v, cfg)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_encode_vs_reference(smoke, n_pe, mode, launches):
    """The encoder: sinusoidal positions, bidirectional attention through
    GQA's projections (the QKV ring on a ring), no other ring."""
    frames = smoke["batch"]["frames"]
    want = jax.jit(smoke["rmodel"].encode)(smoke["rparams"],
                                           jnp.asarray(frames))
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.encode(params, torch.as_tensor(frames))
    _close(got, want, LOGIT_TOL)
    assert launches == {"tile_matmul": smoke["cfg"].enc_layers * 3 * n_pe,
                        "flash_carry": 0}


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_decode_stack_vs_reference(smoke, n_pe, mode, launches):
    """The decoder over a full sequence against the reference's memory:
    self-attention on the QKV ring and ring attention, cross-attention
    and the GELU MLP off the ring."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    memory = np.array(jax.jit(rmodel.encode)(
        rparams, jnp.asarray(smoke["batch"]["frames"])))
    tokens = smoke["batch"]["tokens"]
    want = jax.jit(rmodel.decode_stack)(rparams, jnp.asarray(tokens),
                                        jnp.asarray(memory))
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.decode_stack(params, torch.as_tensor(tokens),
                                 torch.as_tensor(memory))
    _close(got, want, LOGIT_TOL)
    layers = smoke["cfg"].num_layers
    assert launches == {"tile_matmul": layers * 3 * n_pe,
                        "flash_carry": layers * n_pe}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_vs_reference(smoke, n_pe, mode):
    keys = ("frames", "tokens")
    want = jax.jit(smoke["rmodel"].prefill)(smoke["rparams"],
                                            _jnp(smoke["batch"], keys))
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, _torch(smoke["batch"], keys))
    _close(got, want, LOGIT_TOL)


def test_ring_modes_bit_identical(smoke):
    batch = _torch(smoke["batch"], ("frames", "tokens"))
    outs = []
    for mode in ("qlr", "xqueue", "sw"):
        model, params = _port(smoke, 2, mode)
        with torch.no_grad():
            outs.append(model.prefill(params, batch))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("n_pe,mode", RINGS[:3])
def test_loss_and_grads_vs_reference(smoke, n_pe, mode, remat):
    model, params = _port(smoke, n_pe, mode, remat=remat)
    loss, metrics, grads = step_lib.value_and_grad(model, params,
                                                   _torch(smoke["batch"]))
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    assert set(metrics) == {"ce"}
    got, want = _leaves(params_to_reference(grads)), _leaves(smoke["grads"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_fill_cross_cache_and_decode_vs_reference(smoke, n_pe, mode):
    """``fill_cross_cache`` then decode steps with rows masked off (ring
    decode attention on a ring): logits and every cache leaf against the
    reference, step for step."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    cfg = smoke["cfg"]
    b, s = 4, 8
    frames = np.random.default_rng(7).standard_normal(
        (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    rmemory = jax.jit(rmodel.encode)(rparams, jnp.asarray(frames))
    rcache = rmodel.fill_cross_cache(rparams, rmodel.init_cache(b, s),
                                     rmemory)
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        memory = model.encode(params, torch.as_tensor(frames))
        cache = model.fill_cross_cache(params, model.init_cache(b, s, "cpu"),
                                       memory)
    for name in ("cross_k", "cross_v"):
        _close(cache[name], rcache[name], DECODE_TOL)
    step = jax.jit(rmodel.decode_step)
    rng = np.random.default_rng(8)
    for mask in ([True] * 4, [True, False, True, True], [False, True, True,
                                                         True], [True] * 4):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        active = np.array(mask)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        _close(logits, r_logits, DECODE_TOL)
    for name in ("k", "v", "pos"):
        _close(cache["self"][name], rcache["self"][name], DECODE_TOL)


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_prefill_decode_parity(smoke, n_pe, mode):
    """``tests/test_parity.py::test_whisper_prefill_decode_parity`` in the
    port: the encoder once, its cross K/V into the cache, the prompt
    streamed through ``decode_step``; the last logits equal the prefill's
    within 2e-3."""
    cfg = smoke["cfg"]
    model, params = _port(smoke, n_pe, mode)
    rng = np.random.default_rng(1)
    frames = torch.as_tensor(rng.standard_normal(
        (2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 6)))
    with torch.no_grad():
        want = model.prefill(params, {"frames": frames, "tokens": tokens})
        cache = model.fill_cross_cache(params, model.init_cache(2, 32, "cpu"),
                                       model.encode(params, frames))
        for t in range(tokens.shape[1]):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_learned_positions_wrap_like_reference(smoke):
    """Decode past ``max_target_positions``: the learned table is read
    modulo its length, from per-row offsets."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    tokens = np.arange(6, dtype=np.int32).reshape(2, 3)
    offset = np.array([62, 5], np.int32)
    want = rmodel._dec_embed(rparams, jnp.asarray(tokens),
                             pos_offset=jnp.asarray(offset))
    model, params = _port(smoke)
    got = model._dec_embed(params, torch.as_tensor(tokens),
                           pos_offset=torch.as_tensor(offset))
    _close(got, want, LAYER_TOL)


def test_cache_layout_and_axes_match_reference(smoke):
    rcache = smoke["rmodel"].init_cache(4, 16)
    model = build_model(smoke["cfg"])
    cache = model.init_cache(4, 16, "cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), rcache) == \
        opt.tree_map(lambda t: tuple(t.shape), cache)
    assert model.cache_axes() == smoke["rmodel"].cache_axes()


def test_free_slot_zeroes_self_and_cross_rows(smoke):
    """A freed slot loses its row of the self-attention cache and of the
    cross K/V, found by ``cache_axes()``."""
    scfg = ServeConfig(max_batch=4, max_seq_len=8)
    params = build_model(smoke["cfg"]).init(0, "cpu")
    backend = DecodeBackend(smoke["cfg"], scfg, params, device="cpu")
    assert not backend.supports_prefill
    g = torch.Generator().manual_seed(0)
    for leaf in opt.tree_leaves(backend.cache):
        leaf.copy_(torch.randint(1, 9, leaf.shape, generator=g)
                   .to(leaf.dtype))
    before = backend.snapshot_cache()
    backend.free_slot(1)
    keep = [0, 2, 3]
    for got, was in zip(opt.tree_leaves(backend.cache),
                        opt.tree_leaves(before)):
        assert not got[:, 1].any()
        assert torch.equal(got[:, keep], was[:, keep])


def test_bf16_prefill_vs_reference(ref):
    from repro.configs import get_smoke_config as r_smoke
    rcfg, cfg = r_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, rparams, tree = reference_model(rcfg, seed=5)
    keys = ("frames", "tokens")
    batch = _batch(cfg, seed=6)
    want = jax.jit(rmodel.prefill)(rparams, _jnp(batch, keys))
    with torch.no_grad():
        got = build_model(cfg).prefill(params_from_reference(tree, cfg, "cpu"),
                                       _torch(batch, keys))
    _close(got, want, BF16_TOL)
