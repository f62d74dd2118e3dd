"""The port's VLM family (internvl2-1b: the patch projector and patch
prefix) against the reference, on the CPU.

SMOKE internvl2-1b in fp32 with the reference's weights (biases and norm
scales drawn, so they count): 2 layers, 4 heads over 2 KV heads of 16, 8
patches of width 32, tied embeddings, attention biases. Inputs come from
numpy seeds. Bounds:

- the projector and patch prefix: 1e-5 of the largest value (the same
  elementwise formulas and products);
- prefill logits 1e-4 of their scale, dense and on rings of 2 (QKV ring,
  ring attention with a GQA group of 2, FFN ring) and 4 (the QKV ring
  refused: 2 KV heads), in each link mode; the modes bit for bit;
- the loss 1e-4 and every gradient, the projector's included, 1e-3
  (``tests/test_torch_train.py``);
- decode (no patches, as the reference's ``tests/test_parity.py``) against
  the reference and against the port's own prefill: 2e-3;
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

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core import collective_matmul as cm
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
    state_from_reference,
    state_to_reference,
)
from repro_torch.train import step as step_lib

ARCH = "internvl2-1b"
RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(2, "xqueue", id="ring2-xqueue"),
         pytest.param(4, "qlr", id="ring4-qlr")]
LOGIT_TOL, DECODE_TOL, BF16_TOL = 1e-4, 2e-3, 2e-2
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
            "patch_embeds": rng.standard_normal(
                (B, cfg.num_patches, cfg.vit_dim)).astype(np.float32)}


@pytest.fixture(scope="module")
def smoke(ref):
    rcfg, cfg = smoke_fp32(ARCH)
    rmodel, _, tree = reference_model(rcfg, seed=2)
    tree = perturbed(tree, seed=4)
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _batch(cfg)
    (loss, aux), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, jax.tree_util.tree_map(jnp.asarray, batch))
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
    """Every leaf, the unstacked projector's included, survives the round
    trip exactly; the port's own init has the reference's shapes."""
    tree = smoke["tree"]
    params = params_from_reference(tree, smoke["cfg"], "cpu")
    assert set(params["projector"]) == {"w1", "w2", "norm"}
    back = params_to_reference(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    own = params_to_reference(build_model(smoke["cfg"]).init(0, "cpu"))
    assert jax.tree_util.tree_map(np.shape, own) == \
        jax.tree_util.tree_map(np.shape, tree)


def test_train_state_round_trip(ref):
    """A reference train state (bf16 parameters, fp32 moments and masters)
    into the port and back, leaf for leaf."""
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    tcfg = TrainConfig()
    rstate = rstep.init_state(r_smoke(ARCH), tcfg, jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, rstate)
    state = state_from_reference(tree, get_smoke_config(ARCH), tcfg, "cpu")
    assert state["params"]["projector"]["w1"].dtype == torch.bfloat16
    assert state["opt"]["m"]["projector"]["w2"].dtype == torch.float32
    back = dict(jax.tree_util.tree_leaves_with_path(state_to_reference(state)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            np.asarray(a, np.float32) if a.dtype != np.int32 else a,
            back[path])


@pytest.mark.parametrize("seq", [16, 6], ids=["P<S", "P>S"])
def test_patch_prefix_vs_reference(smoke, seq):
    """The projector (norm at vit_dim, w1, tanh GELU, w2) overwrites the
    first min(P, S) positions; with P > S the patches are truncated."""
    batch = _batch(smoke["cfg"], s=seq)
    want = smoke["rmodel"]._embed_inputs(
        smoke["rparams"], {k: jnp.asarray(batch[k])
                           for k in ("tokens", "patch_embeds")})
    model, params = _port(smoke)
    with torch.no_grad():
        got = model._embed_inputs(params, torch.as_tensor(batch["tokens"]),
                                  torch.as_tensor(batch["patch_embeds"]))
        plain = model._embed_inputs(params, torch.as_tensor(batch["tokens"]))
    assert got.shape == (B, seq, smoke["cfg"].d_model)
    _close(got, want, 1e-5)
    n = min(seq, smoke["cfg"].num_patches)
    assert torch.equal(got[:, n:], plain[:, n:])
    assert not torch.equal(got[:, :n], plain[:, :n])


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_with_patches_vs_reference(smoke, n_pe, mode, launches):
    batch = smoke["batch"]
    want = jax.jit(smoke["rmodel"].prefill)(
        smoke["rparams"], {k: jnp.asarray(batch[k])
                           for k in ("tokens", "patch_embeds")})
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(batch["tokens"]),
                            torch.as_tensor(batch["patch_embeds"]))
    _close(got, want, LOGIT_TOL)
    layers = smoke["cfg"].num_layers
    # per layer: the FFN rings (n x 3), the QKV ring where the KV heads
    # divide the ring (n x 3), ring attention's n hops
    qkv = 3 * n_pe if n_pe == 2 else 0
    assert launches == {"tile_matmul": layers * (3 * n_pe + qkv),
                        "flash_carry": layers * n_pe}


def test_ring_modes_bit_identical(smoke):
    tokens = torch.as_tensor(smoke["batch"]["tokens"])
    patches = torch.as_tensor(smoke["batch"]["patch_embeds"])
    outs = []
    for mode in ("qlr", "xqueue", "sw"):
        model, params = _port(smoke, 2, mode)
        with torch.no_grad():
            outs.append(model.prefill(params, tokens, patches))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_loss_and_grads_vs_reference(smoke, n_pe, mode):
    """Every gradient against ``jax.value_and_grad``, the projector's
    included (and nonzero)."""
    model, params = _port(smoke, n_pe, mode)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    got, want = _leaves(params_to_reference(grads)), _leaves(smoke["grads"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    for name in ("w1", "w2"):
        assert float(grads["projector"][name].abs().max()) > 0, name


def test_loss_without_patches_leaves_projector_untouched(smoke):
    model, params = _port(smoke)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()
             if k != "patch_embeds"}
    _, _, grads = step_lib.value_and_grad(model, params, batch)
    assert not any(float(g.abs().max()) for g in
                   (grads["projector"]["w1"], grads["projector"]["w2"]))


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_prefill_into_cache_then_decode_vs_reference(smoke, n_pe, mode):
    """Decode takes no patches: block prefill into one slot, then decode
    steps with a row masked off, logits and cache against the reference."""
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
    _close(logit, r_logit, DECODE_TOL)
    step = jax.jit(rmodel.decode_step)
    active = np.array([True, True, False, True])
    for _ in range(3):
        toks = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        _close(logits, r_logits, DECODE_TOL)
    for name in ("k", "v", "pos"):
        _close(cache["layers"][name], rcache["layers"][name], DECODE_TOL)


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_prefill_vs_streamed_decode_without_patches(smoke, n_pe, mode):
    model, params = _port(smoke, n_pe, mode)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, smoke["cfg"].vocab_size, (2, 12)))
    with torch.no_grad():
        want = model.prefill(params, tokens)
        cache = model.init_cache(2, 12, "cpu")
        for t in range(tokens.shape[1]):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    torch.testing.assert_close(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_cache_axes_match_reference(smoke):
    assert build_model(smoke["cfg"]).cache_axes() == \
        smoke["rmodel"].cache_axes()


def test_rings_engage_as_the_reference_gates(smoke):
    cfg = smoke["cfg"]
    x = torch.zeros(B, S, cfg.d_model)
    for n, qkv in ((2, True), (4, False)):
        assert cm.attn_applicable(x, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.resolved_head_dim, n) == qkv
        assert cm.ffn_applicable(x, cfg.d_ff, n)
    full = get_config(ARCH)
    # at full width: 14 heads over 2 KV heads split 2 ways, not 4
    assert cm.attn_applicable(torch.zeros(1, 2048, 1), full.num_heads,
                              full.num_kv_heads, full.resolved_head_dim, 2)
    assert not cm.attn_applicable(torch.zeros(1, 2048, 1), full.num_heads,
                                  full.num_kv_heads, full.resolved_head_dim,
                                  4)


def test_bf16_prefill_vs_reference(ref):
    """Both packages in bf16 from the same bf16 weights: 2e-2 of the
    logits' scale."""
    from repro.configs import get_smoke_config as r_smoke
    rcfg, cfg = r_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, rparams, tree = reference_model(rcfg, seed=5)
    batch = _batch(cfg, seed=6)
    want = jax.jit(rmodel.prefill)(rparams, {
        k: jnp.asarray(batch[k]) for k in ("tokens", "patch_embeds")})
    model = build_model(cfg)
    params = params_from_reference(tree, cfg, "cpu")
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(batch["tokens"]),
                            torch.as_tensor(batch["patch_embeds"]))
    _close(got, want, BF16_TOL)
