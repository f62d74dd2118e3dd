"""The port's MLA (DeepSeek-V2's multi-head latent attention) and
deepseek-v2-lite-16b against the reference, on the CPU.

SMOKE deepseek-v2-lite-16b in fp32 with the reference's weights (norm
scales drawn, so they count): 3 layers, the first dense (d_ff_dense 128),
then MoE layers of 8 experts top-2 with 2 shared experts; MLA with 4
heads, latent rank 32, nope/rope/v head dims 16/8/16. Inputs come from
numpy seeds. Bounds:

- ``_mla_latent``, ``_mla_queries``, ``mla_forward`` and ``_mla_blocked``
  (a small ``kv_block`` over a ragged S): 1e-5 of the largest value (the
  same fp32 formulas; the blocked online softmax against the
  reference's);
- ``mla_decode``: outputs and cache 2e-3, as every decode check
  (``tests/test_parity.py``);
- prefill logits 1e-4 of their scale, dense and on rings of 2 and 4 (MLA
  has no ring path; only layer 0's SwiGLU takes the FFN ring, since the
  expert ring refuses shared experts), the loss 1e-4 and every gradient
  1e-3 (``tests/test_torch_train.py``);
- absorbed decode against the expanded prefill: 2e-3;
- bf16 prefill against the reference's bf16 prefill: 2e-2.
"""
from __future__ import annotations

import math
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
from test_torch_serve import _drive, assert_lockstep

from repro_torch.configs import (
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core import ring_moe
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
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARCH = "deepseek-v2-lite-16b"
RINGS = [pytest.param(0, "baseline", id="dense"),
         pytest.param(2, "qlr", id="ring2-qlr"),
         pytest.param(2, "sw", id="ring2-sw"),
         pytest.param(4, "xqueue", id="ring4-xqueue")]
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


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": raw[:, :-1], "targets": raw[:, 1:],
            "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


@pytest.fixture(scope="module")
def smoke(ref):
    rcfg, cfg = smoke_fp32(ARCH)
    rmodel, _, tree = reference_model(rcfg, seed=2)
    tree = perturbed(tree, seed=4)
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _batch(cfg.vocab_size)
    (loss, aux), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, jax.tree_util.tree_map(jnp.asarray, batch))
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams,
                tree=tree, batch=batch, loss=float(loss),
                aux=float(aux["aux"]), grads=grads)


def _port(sm, n_pe=0, mode="baseline", **overrides):
    cfg = replace(sm["cfg"], systolic_mode=mode, **overrides)
    return build_model(cfg, n_pe=n_pe), params_from_reference(
        sm["tree"], cfg, "cpu")


def _attn_params(sm, layer=0):
    """Layer ``layer``'s MLA leaves: numpy (the reference's stacks) and
    the port's tensors."""
    group, i = ("dense_layers", layer) if layer == 0 else ("layers",
                                                            layer - 1)
    leaves = {k: np.array(v[i]) for k, v in sm["tree"][group]["attn"]
              .items()}
    return leaves, {k: torch.as_tensor(v) for k, v in leaves.items()}


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
    """``dense_layers`` and ``layers`` become one list (the dense layer
    first) and go back exactly; MLA's ``kv_norm`` is 1-D per layer."""
    tree = smoke["tree"]
    params = params_from_reference(tree, smoke["cfg"], "cpu")
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]
    assert set(params["layers"][0]["attn"]) == {
        "wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    assert params["layers"][2]["attn"]["kv_norm"].shape == \
        (smoke["cfg"].kv_lora_rank,)
    back = params_to_reference(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    own = params_to_reference(build_model(smoke["cfg"]).init(0, "cpu"))
    assert jax.tree_util.tree_map(np.shape, own) == \
        jax.tree_util.tree_map(np.shape, tree)


def test_train_state_round_trip(ref):
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    tcfg = TrainConfig()
    rstate = rstep.init_state(r_smoke(ARCH), tcfg, jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, rstate)
    state = state_from_reference(tree, get_smoke_config(ARCH), tcfg, "cpu")
    lp = state["params"]["layers"][1]
    assert lp["attn"]["kv_norm"].dtype == torch.bfloat16
    assert lp["moe"]["router"].dtype == torch.float32
    back = dict(jax.tree_util.tree_leaves_with_path(state_to_reference(state)))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(
            np.asarray(a, np.float32) if a.dtype != np.int32 else a,
            back[path])


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_latent_and_queries_vs_reference(smoke):
    from repro.models import attention as rattn
    rcfg, cfg = smoke["rcfg"], smoke["cfg"]
    leaves, tp = _attn_params(smoke, 1)
    x = _x(cfg, B, 12)
    pos = np.arange(12)[None, :].astype(np.int32)
    want_c, want_kr = rattn._mla_latent(leaves, jnp.asarray(x), rcfg,
                                        jnp.asarray(pos))
    want_qn, want_qr = rattn._mla_queries(leaves, jnp.asarray(x), rcfg,
                                          jnp.asarray(pos))
    c, kr = attn._mla_latent(tp, torch.as_tensor(x), cfg,
                             torch.as_tensor(pos))
    qn, qr = attn._mla_queries(tp, torch.as_tensor(x), cfg,
                               torch.as_tensor(pos))
    assert kr.shape == (B, 12, cfg.qk_rope_head_dim)
    for got, want in ((c, want_c), (kr, want_kr), (qn, want_qn),
                      (qr, want_qr)):
        _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("s", [12, 2048], ids=["expanded", "blocked"])
def test_mla_forward_vs_reference(smoke, s):
    """Below the threshold the expanded scores; at 2048 the blocked
    stream, in both packages."""
    from repro.models import attention as rattn
    leaves, tp = _attn_params(smoke, 0)
    b = B if s < attn.BLOCKED_ATTN_THRESHOLD else 1
    x = _x(smoke["cfg"], b, s, seed=1)
    want = rattn.mla_forward(leaves, jnp.asarray(x), smoke["rcfg"])
    got = attn.mla_forward(tp, torch.as_tensor(x), smoke["cfg"])
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("kv_block", [8, 5])
def test_mla_blocked_vs_reference(smoke, kv_block):
    """``_mla_blocked`` at a small block over a ragged S (padded to whole
    blocks, keys past S masked), against the reference's and against the
    expanded form."""
    from repro.models import attention as rattn
    rcfg, cfg = smoke["rcfg"], smoke["cfg"]
    leaves, tp = _attn_params(smoke, 2)
    s = 21
    x = _x(cfg, B, s, seed=2)
    pos = np.arange(s)[None, :].astype(np.int32)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    qn, qr = rattn._mla_queries(leaves, jx, rcfg, jpos)
    c, kr = rattn._mla_latent(leaves, jx, rcfg, jpos)
    want = rattn._mla_blocked(leaves, qn, qr, c, kr, rcfg, scale,
                              kv_block=kv_block)
    tx, tpos = torch.as_tensor(x), torch.as_tensor(pos)
    tqn, tqr = attn._mla_queries(tp, tx, cfg, tpos)
    tc, tkr = attn._mla_latent(tp, tx, cfg, tpos)
    got = attn._mla_blocked(tp, tqn, tqr, tc, tkr, cfg, scale,
                            kv_block=kv_block)
    assert got.shape == (B, s, cfg.num_heads, cfg.v_head_dim)
    _close(got, want, LAYER_TOL)
    expanded = torch.einsum("bshk,hkd->bsd", got, tp["wo"])
    _close(expanded, attn.mla_forward(tp, tx, cfg), LAYER_TOL)


def test_mla_decode_vs_reference(smoke):
    """Absorbed decode, step for step against the reference's, with rows
    masked off and the cache run full (a full cache overwrites its last
    slot): outputs and every cache leaf."""
    from repro.models import attention as rattn
    rcfg, cfg = smoke["rcfg"], smoke["cfg"]
    leaves, tp = _attn_params(smoke, 1)
    b, s_cache = 4, 6
    rcache = rattn.init_mla_cache(rcfg, b, s_cache)
    cache = attn.init_mla_cache(cfg, b, s_cache, "cpu")
    step = jax.jit(lambda x, c, a: rattn.mla_decode(leaves, x, c, rcfg,
                                                    active=a))
    rng = np.random.default_rng(3)
    for t in range(9):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        active = np.array([True, t % 3 != 1, t % 2 == 0, True])
        want, rcache = step(jnp.asarray(x), rcache, jnp.asarray(active))
        got, cache = attn.mla_decode(tp, torch.as_tensor(x), cache, cfg,
                                     active=torch.as_tensor(active))
        _close(got, want, DECODE_TOL)
    assert int(cache["pos"].max()) > s_cache
    for name in ("c", "k_rope", "pos"):
        _close(cache[name], rcache[name], DECODE_TOL)


# ---------------------------------------------------------------------------
# deepseek SMOKE end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_vs_reference(smoke, n_pe, mode, launches):
    """Logits against the reference; only layer 0's SwiGLU runs a ring
    (n x 3 tile matmuls): MLA has no ring path and the expert ring refuses
    shared experts."""
    tokens = smoke["batch"]["tokens"]
    want = jax.jit(smoke["rmodel"].prefill)(
        smoke["rparams"], {"tokens": jnp.asarray(tokens)})
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    _close(got, want, LOGIT_TOL)
    assert launches == {"tile_matmul": 3 * n_pe * smoke["cfg"].first_k_dense,
                        "flash_carry": 0}


def test_expert_ring_refuses_shared_experts(smoke):
    cfg = replace(smoke["cfg"], systolic_mode="qlr")
    x = torch.zeros(B, S, cfg.d_model)
    assert not ring_moe.ring_moe_applicable(cfg, x, 2)
    assert ring_moe.ring_moe_applicable(replace(cfg, num_shared_experts=0),
                                        x, 2)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_loss_and_grads_vs_reference(smoke, n_pe, mode):
    model, params = _port(smoke, n_pe, mode)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    assert float(metrics["aux"]) == pytest.approx(smoke["aux"], abs=LOSS_TOL)
    got, want = _leaves(params_to_reference(grads)), _leaves(smoke["grads"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


def test_ring_modes_bit_identical(smoke):
    tokens = torch.as_tensor(smoke["batch"]["tokens"])
    outs = []
    for mode in ("qlr", "xqueue", "sw"):
        model, params = _port(smoke, 2, mode)
        with torch.no_grad():
            outs.append(model.prefill(params, tokens))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_absorbed_decode_vs_expanded_prefill(smoke, n_pe, mode):
    """``tests/test_parity.py``'s deepseek check in the port: the absorbed
    decode streamed over the prompt ends at the expanded prefill's
    logits. 12 tokens fit every expert's 16 slots, so the prefill's MoE
    drops nothing (see the next test)."""
    model, params = _port(smoke, n_pe, mode)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, smoke["cfg"].vocab_size, (2, 12)))
    with torch.no_grad():
        want = model.prefill(params, tokens)
        cache = model.init_cache(2, 12, "cpu")
        for t in range(tokens.shape[1]):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    _close(got, want, DECODE_TOL)


def test_capacity_drops_split_prefill_from_decode(smoke):
    """Past an expert's capacity a prefill's MoE drops assignments that a
    one-token decode step keeps, in the reference as in the port: over 24
    tokens (16 slots an expert) the two paths part by the same amount in
    both packages, while their prefills agree. So prefill-against-decode
    checks of an MoE model stay within capacity."""
    from repro_torch.models import moe
    cfg = smoke["cfg"]
    s = 24
    assert moe.expert_capacity(cfg, s) < s
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, s))
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    r_pre = np.asarray(rmodel.prefill(rparams,
                                      {"tokens": jnp.asarray(tokens)}))
    rcache = rmodel.init_cache(B, s)
    step = jax.jit(rmodel.decode_step)
    for t in range(s):
        r_dec, rcache = step(rparams, rcache, jnp.asarray(tokens[:, t:t + 1]))
    model, params = _port(smoke)
    with torch.no_grad():
        pre = model.prefill(params, torch.as_tensor(tokens))
        cache = model.init_cache(B, s, "cpu")
        for t in range(s):
            dec, cache = model.decode_step(params, cache,
                                           torch.as_tensor(tokens[:, t:t + 1]))
    _close(pre, r_pre, LOGIT_TOL)
    _close(dec, r_dec, DECODE_TOL)
    gap = float(np.abs(r_pre - np.asarray(r_dec)).max())
    assert gap > 10 * DECODE_TOL * max(1.0, float(np.abs(r_pre).max()))
    assert float((pre - dec).abs().max()) == pytest.approx(gap, rel=1e-3)


def test_decode_vs_reference(smoke):
    """Decode steps with rows masked off: logits and every cache leaf
    (``dense_layers`` and ``layers`` in the reference, one stack here)."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    rng = np.random.default_rng(2)
    b, s = 4, 8
    rcache = rmodel.init_cache(b, s)
    model, params = _port(smoke)
    cache = model.init_cache(b, s, "cpu")
    step = jax.jit(rmodel.decode_step)
    for mask in ([True] * 4, [True, False, True, True], [False, True, True,
                                                         True]):
        toks = rng.integers(0, smoke["cfg"].vocab_size, (b, 1)).astype(
            np.int32)
        active = np.array(mask)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        _close(logits, r_logits, DECODE_TOL)
    for name in ("c", "k_rope", "pos"):
        want = np.concatenate([np.asarray(rcache["dense_layers"][name]),
                               np.asarray(rcache["layers"][name])])
        _close(cache["layers"][name], want, DECODE_TOL)


def test_cache_axes_match_reference(smoke):
    """The reference pads MLA's axes in both of its stacks; the port keeps
    one stack with the same axes."""
    theirs = smoke["rmodel"].cache_axes()
    assert theirs["dense_layers"] == theirs["layers"]
    assert build_model(smoke["cfg"]).cache_axes() == \
        {"layers": theirs["layers"]}


def test_prefill_into_cache_refuses_mla(smoke):
    model, params = _port(smoke)
    with pytest.raises(NotImplementedError, match="GQA"):
        model.prefill_into_cache(params, model.init_cache(2, 8, "cpu"),
                                 torch.zeros(4, dtype=torch.int32), 0, 4)


def test_bf16_prefill_vs_reference(ref):
    from repro.configs import get_smoke_config as r_smoke
    rcfg, cfg = r_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, rparams, tree = reference_model(rcfg, seed=5)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    want = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = build_model(cfg).prefill(params_from_reference(tree, cfg, "cpu"),
                                       torch.as_tensor(tokens))
    _close(got, want, BF16_TOL)


# ---------------------------------------------------------------------------
# serving: prompts stream through the absorbed decode
# ---------------------------------------------------------------------------


def test_free_slot_zeroes_latent_rows(smoke):
    """``DecodeBackend`` streams prompts (no block prefill for MLA), and a
    freed slot loses exactly its row of ``c``, ``k_rope`` and ``pos`` in
    every layer."""
    scfg = ServeConfig(max_batch=4, max_seq_len=8, prefill_chunk=8)
    params = build_model(smoke["cfg"]).init(0, "cpu")
    backend = DecodeBackend(smoke["cfg"], scfg, params, device="cpu")
    assert not backend.supports_prefill and backend.prefill_len(6) == 0
    g = torch.Generator().manual_seed(0)
    for leaf in opt.tree_leaves(backend.cache):
        leaf.copy_(torch.randint(1, 9, leaf.shape, generator=g)
                   .to(leaf.dtype))
    before = backend.snapshot_cache()
    backend.free_slot(2)
    for name, leaf in backend.cache["layers"].items():
        old = before["layers"][name]
        assert not leaf[:, 2].any(), name
        keep = [0, 1, 3]
        assert torch.equal(leaf[:, keep], old[:, keep]), name


SCFG = dict(max_batch=4, max_seq_len=32, temperature=0.0, prefill_chunk=8)


def _schedule(vocab):
    """[(tick, prompt, max_new)]: 4 requests up front, 2 admitted later
    into freed slots."""
    rng = np.random.default_rng(0)
    return [(tick, rng.integers(0, vocab, int(rng.integers(2, 10)))
             .astype(np.int32), int(rng.integers(3, 6)))
            for tick in (0, 0, 0, 0, 6, 9)]


@pytest.fixture(scope="module")
def reference_run(ref):
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.engine import ServeEngine as RServeEngine
    rcfg, cfg = smoke_fp32(ARCH)
    _, rparams, tree = reference_model(rcfg)
    engine = RServeEngine(rcfg, RServeConfig(**SCFG), rparams)
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: np.asarray(x, np.float32))
    return cfg, tree, record


@pytest.mark.parametrize("n_pe,mode", [(0, "dense"), (2, "qlr")])
def test_greedy_serving_matches_reference_engine(reference_run, n_pe, mode):
    """Prompts stream through the absorbed decode in both engines; the
    requests admitted later reuse freed slots."""
    cfg, tree, ref_record = reference_run
    scfg = ServeConfig(**SCFG)
    params = params_from_reference(tree, cfg, device="cpu")
    backend = RingShardedBackend(cfg, scfg, params, n_pe, mode,
                                 device="cpu") if n_pe \
        else DecodeBackend(cfg, scfg, params, device="cpu")
    assert not backend.supports_prefill
    engine = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
    record = _drive(engine, _schedule(cfg.vocab_size),
                    lambda x: x.numpy().astype(np.float32),
                    commit_tokens=[r[2] for r in ref_record])
    assert_lockstep(record, ref_record)
