"""The port's dense model against the reference ``TransformerLM``.

SMOKE qwen3-0.6b in fp32 with the reference's own weights (converted by
``params_from_reference``); bounds as ``tests/test_parity.py``: 2e-3.
The ring variants run the emulated ring at the SMOKE widths (kv heads 2:
only a ring of 2 engages the QKV ring) through the kernel wrappers' CPU
twins.
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

from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
)

TOL = 2e-3
RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(4, "xqueue", id="ring4-xqueue")]


@pytest.fixture(scope="module")
def smoke(ref):
    rcfg, cfg = smoke_fp32()
    rmodel, rparams, tree = reference_model(rcfg)
    return rcfg, cfg, rmodel, rparams, tree


def _port(cfg, tree, n_pe, mode):
    cfg = replace(cfg, systolic_mode=mode)
    return build_model(cfg, n_pe=n_pe), params_from_reference(tree, cfg,
                                                              device="cpu")


def test_params_round_trip(smoke):
    _, cfg, _, _, tree = smoke
    back = params_to_reference(params_from_reference(tree, cfg, "cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(a), flat_b[path])


def test_params_round_trip_bf16(ref):
    """bfloat16 leaves survive the numpy hop exactly."""
    from repro.configs import get_smoke_config as r_smoke
    from repro_torch.configs import get_smoke_config
    _, _, tree = reference_model(r_smoke("qwen3-0.6b"))
    params = params_from_reference(tree, get_smoke_config("qwen3-0.6b"),
                                   "cpu")
    assert params["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_to_reference(params)["layers"]["attn"]["wq"],
        np.asarray(tree["layers"]["attn"]["wq"], np.float32))


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_logits_vs_reference(smoke, n_pe, mode):
    rcfg, cfg, rmodel, rparams, tree = smoke
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(jax.jit(rmodel.prefill)(rparams,
                                              {"tokens": jnp.asarray(tokens)}))
    model, params = _port(cfg, tree, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_into_cache_then_decode_vs_reference(smoke, n_pe, mode):
    """Block prefill into one slot, then decode steps with a row masked
    off: logits and the cache match the reference step for step."""
    rcfg, cfg, rmodel, rparams, tree = smoke
    rng = np.random.default_rng(2)
    b, s, c, length = 4, 16, 8, 5
    chunk = rng.integers(0, cfg.vocab_size, c).astype(np.int32)
    rcache = rmodel.init_cache(b, s)
    r_logit, rcache = jax.jit(rmodel.prefill_into_cache)(
        rparams, rcache, jnp.asarray(chunk), jnp.int32(1), jnp.int32(length))
    model, params = _port(cfg, tree, n_pe, mode)
    cache = model.init_cache(b, s, "cpu")
    with torch.no_grad():
        logit, cache = model.prefill_into_cache(
            params, cache, torch.as_tensor(chunk), 1, length)
    np.testing.assert_allclose(logit.numpy(), np.asarray(r_logit), rtol=TOL,
                               atol=TOL)
    step = jax.jit(rmodel.decode_step)
    active = np.array([True, True, False, True])
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=TOL, atol=TOL)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(rcache["layers"][name]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_pe,mode", [RINGS[0], RINGS[2]])
def test_full_cache_overwrites_last_slot_like_reference(smoke, n_pe, mode):
    """Decoding past the cache clamps the write to the last slot
    (``min(pos, s_cache - 1)``), in step with the reference."""
    rcfg, cfg, rmodel, rparams, tree = smoke
    b, s = 2, 4
    rng = np.random.default_rng(3)
    rcache = rmodel.init_cache(b, s)
    model, params = _port(cfg, tree, n_pe, mode)
    cache = model.init_cache(b, s, "cpu")
    step = jax.jit(rmodel.decode_step)
    for _ in range(s + 2):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks))
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache,
                                              torch.as_tensor(toks))
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=TOL, atol=TOL)
    assert cache["layers"]["pos"][0].tolist() == [s + 2] * b


@pytest.mark.parametrize("variant", [
    dict(sliding_window=3),                         # ring-buffer decode cache
    dict(tie_embeddings=False, use_attn_bias=True),  # untied head, biases
])
def test_config_variants_vs_reference(ref, variant):
    """The other ModelConfig branches of the slice, dense: prefill logits
    and decode steps past the window match the reference."""
    rcfg, cfg = smoke_fp32()
    rcfg, cfg = replace(rcfg, **variant), replace(cfg, **variant)
    rmodel, rparams, tree = reference_model(rcfg)
    model, params = _port(cfg, tree, 0, "baseline")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jax.jit(rmodel.prefill)(rparams,
                                              {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    rcache, cache = rmodel.init_cache(2, 8), model.init_cache(2, 8, "cpu")
    step = jax.jit(rmodel.decode_step)
    for t in range(tokens.shape[1]):
        r_logits, rcache = step(rparams, rcache, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(tokens[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_pe,engaged", [
    (2, {"systolic_qkv", "systolic_ring_attention", "systolic_ffn",
         "systolic_ring_decode"}),
    # SMOKE has 2 kv heads: a ring of 4 cannot split them, so QKV stays dense
    (4, {"systolic_ring_attention", "systolic_ffn", "systolic_ring_decode"}),
    (0, set()),
])
def test_applicability_gates_pick_the_reference_rings(smoke, n_pe, engaged):
    from unittest import mock
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import ring_attention as ra
    _, cfg, _, _, tree = smoke
    model, params = _port(cfg, tree, n_pe, "qlr" if n_pe else "baseline")
    calls = set()
    patches = []
    for mod, name in ((cm, "systolic_qkv"), (cm, "systolic_ffn"),
                      (cm, "systolic_out_proj"),
                      (ra, "systolic_ring_attention"),
                      (ra, "systolic_ring_decode")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.add(_name)
            return _real(*a, **k)
        patches.append(mock.patch.object(mod, name, spy))
    for p in patches:
        p.start()
    try:
        cache = model.init_cache(4, 16, "cpu")
        with torch.no_grad():
            model.prefill_into_cache(params, cache, torch.arange(8), 0, 8)
            model.decode_step(params, cache, torch.zeros(4, 1, dtype=int))
    finally:
        for p in patches:
            p.stop()
    assert calls == engaged
