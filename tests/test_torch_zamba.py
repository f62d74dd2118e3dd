"""The port's Zamba2 hybrid (zamba2-1.2b) and the Mamba2/Zamba losses against
the reference, on the CPU; the ``ssd_chunks`` backward; freed serving
slots; the launchers with the new configs.

SMOKE zamba2-1.2b in fp32 with the reference's own weights: 5 Mamba2
layers in 2 super-blocks of 2 and a tail of 1, the shared block with 4
heads (MHA) of 16, chunk 8. Bounds:

- prefill and decode logits and every cache leaf: 2e-3
  (``tests/test_parity.py``), also for the port's prefill against its
  own streamed decode;
- the loss 1e-4 and every gradient 1e-3 (``tests/test_torch_train.py``),
  dense and on a ring of 2 in each link mode, with and without remat;
- ``_SSDChunks`` (the card's path: the kernel forward, the twin's
  gradient backward) with the twin standing in for the kernel: its
  gradients equal the twin's autograd bit for bit;
- freed slots: exactly one row of each cache leaf is zeroed, and a reused
  slot decodes bit for bit like a fresh engine;
- greedy serving in lockstep with the reference's engine: tokens equal
  except at fp near-ties (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

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
from test_torch_serve import SCFG, _drive, _schedule, assert_lockstep

from repro_torch.configs import (
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.kernels.systolic_matmul import ops as mm_ops
from repro_torch.models import (
    build_model,
    params_from_reference,
    params_to_reference,
    state_to_reference,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARCH = "zamba2-1.2b"
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


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": raw[:, :-1], "targets": raw[:, 1:],
            "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


def _reference(arch):
    rcfg, cfg = smoke_fp32(arch)
    rmodel, rparams, tree = reference_model(rcfg, seed=1)
    batch = _batch(cfg.vocab_size)
    (loss, _), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        rparams, jax.tree_util.tree_map(jnp.asarray, batch))
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams,
                tree=tree, batch=batch, loss=float(loss), grads=grads)


@pytest.fixture(scope="module")
def smoke(ref):
    return _reference(ARCH)


@pytest.fixture(scope="module")
def mamba_smoke(ref):
    return _reference("mamba2-1.3b")


def _port(sm, n_pe=0, mode="baseline", **overrides):
    cfg = replace(sm["cfg"], systolic_mode=mode, **overrides)
    return build_model(cfg, n_pe=n_pe), params_from_reference(
        sm["tree"], cfg, "cpu")


def _assert_grads(grads, want):
    got, want = _leaves(params_to_reference(grads)), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# parameters, config, cache layout
# ---------------------------------------------------------------------------


def test_config_and_tree_match_reference(smoke):
    import dataclasses
    from repro.configs import get_config as r_config
    for mine, theirs in ((get_config(ARCH), r_config(ARCH)),):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    params = params_from_reference(smoke["tree"], smoke["cfg"], "cpu")
    assert len(params["adapters"]) == 2 and len(params["tail"]) == 1
    assert [len(s) for s in params["mamba"]] == [2, 2]
    back = params_to_reference(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    want = jax.tree_util.tree_leaves_with_path(smoke["tree"])
    assert len(flat) == len(want)
    for path, a in want:
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    init = build_model(smoke["cfg"]).init(0, "cpu")
    shapes = jax.tree_util.tree_map(lambda a: np.shape(a), smoke["tree"])
    assert jax.tree_util.tree_map(
        lambda a: np.shape(a), params_to_reference(init)) == shapes


def test_param_round_trip_bf16_keeps_fp32_leaves():
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(0, "cpu")
    back = params_from_reference(params_to_reference(params), cfg, "cpu")
    for stack, bstack in zip(params["mamba"], back["mamba"]):
        for lp, lb in zip(stack, bstack):
            for name, t in lp["mixer"].items():
                want = torch.float32 if name in ("A_log", "D", "dt_bias") \
                    else torch.bfloat16
                assert t.dtype == lb["mixer"][name].dtype == want, name
                assert torch.equal(t, lb["mixer"][name])
    assert torch.equal(params["shared"]["mlp"]["b_up"],
                       back["shared"]["mlp"]["b_up"])


def test_cache_layout_and_axes_match_reference(smoke):
    rcache = smoke["rmodel"].init_cache(4, 16)
    model = build_model(smoke["cfg"])
    cache = model.init_cache(4, 16, "cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), rcache) == \
        opt.tree_map(lambda t: tuple(t.shape), cache)
    assert model.cache_axes() == smoke["rmodel"].cache_axes()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b",
                                  "mamba2-1.3b"])
def test_cache_axes_match_reference(ref, arch):
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import build_model as r_build
    mine = build_model(get_smoke_config(arch)).cache_axes()
    theirs = r_build(r_smoke(arch)).cache_axes()
    assert mine == theirs


# ---------------------------------------------------------------------------
# forward, decode, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_prefill_vs_reference(smoke, n_pe, mode):
    tokens = np.random.default_rng(1).integers(
        0, smoke["cfg"].vocab_size, (2, 16)).astype(np.int32)
    want = jax.jit(smoke["rmodel"].prefill)(
        smoke["rparams"], {"tokens": jnp.asarray(tokens)})
    model, params = _port(smoke, n_pe, mode)
    with torch.no_grad():
        got = model.prefill(params, torch.as_tensor(tokens))
    _close(got, want, TOL)


@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_decode_vs_reference(smoke, n_pe, mode):
    """Decode steps with rows masked off: logits and every cache leaf
    match the reference step for step (ring decode attention on a ring)."""
    rmodel, rparams = smoke["rmodel"], smoke["rparams"]
    rng = np.random.default_rng(2)
    b, s = 4, 16
    rcache = rmodel.init_cache(b, s)
    model, params = _port(smoke, n_pe, mode)
    cache = model.init_cache(b, s, "cpu")
    step = jax.jit(rmodel.decode_step)
    masks = [[True] * 4, [True, False, True, True], [False, True, True, True],
             [True] * 4, [True, True, True, False]]
    for mask in masks:
        toks = rng.integers(0, smoke["cfg"].vocab_size, (b, 1)).astype(
            np.int32)
        active = np.array(mask)
        r_logits, rcache = step(rparams, rcache, jnp.asarray(toks),
                                jnp.asarray(active))
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(toks), torch.as_tensor(active))
        _close(logits, r_logits, TOL)
    got, want = opt.tree_leaves(cache), jax.tree_util.tree_leaves(rcache)
    assert len(got) == len(want)
    flat = dict(jax.tree_util.tree_leaves_with_path(rcache))
    for path, v in flat.items():
        node = cache
        for key in path:
            node = node[key.key]
        _close(node, v, TOL)


@pytest.mark.parametrize("n_pe,mode", [(0, "baseline"), (2, "qlr")])
def test_prefill_vs_streamed_decode(smoke, n_pe, mode):
    model, params = _port(smoke, n_pe, mode)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, smoke["cfg"].vocab_size, (2, 24)))
    with torch.no_grad():
        want = model.prefill(params, tokens)
        cache = model.init_cache(2, 24, "cpu")
        for t in range(tokens.shape[1]):
            got, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("n_pe,mode", RINGS)
def test_loss_and_grads_vs_reference(smoke, n_pe, mode, remat):
    model, params = _port(smoke, n_pe, mode, remat=remat)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    assert set(metrics) == {"ce"}
    _assert_grads(grads, smoke["grads"])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_mamba_lm_loss_and_grads_vs_reference(mamba_smoke, remat):
    model, params = _port(mamba_smoke, remat=remat)
    batch = {k: torch.as_tensor(v) for k, v in mamba_smoke["batch"].items()}
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(mamba_smoke["loss"], abs=LOSS_TOL)
    assert float(metrics["ce"]) == float(loss)
    _assert_grads(grads, mamba_smoke["grads"])


def test_mamba_lm_refuses_a_ring():
    with pytest.raises(NotImplementedError, match="no ring"):
        build_model(get_smoke_config("mamba2-1.3b"), n_pe=2)


# ---------------------------------------------------------------------------
# the card path's autograd.Functions, with the twins as their kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_functions(monkeypatch):
    """Route the CPU wrappers of ``ssd_chunks`` and ``tile_matmul`` through
    ``_SSDChunks`` and ``_TileMatmul``, whose forward calls ``*_cuda``:
    here the twin, counting launches as the kernel wrappers do.
    ``flash_carry`` goes through ``_FlashCarry`` on the CPU too: its
    forward and backward twins stand in for the two flash kernels and
    count their launches."""
    plain_ssd, plain_mm = sk.ssd_chunks_plain, mk.matmul_plain
    plain_flash, plain_bwd = fk.flash_carry_plain, \
        fk.flash_carry_backward_plain
    launches = {"ssd_chunks": 0, "tile_matmul": 0, "flash_carry": 0,
                "flash_carry_bwd": 0}

    def ssd_kernel(*args, **kw):
        launches["ssd_chunks"] += 1
        return plain_ssd(*args, **kw)

    def mm_kernel(a, b, c=None, out_dtype=None, block=0):
        launches["tile_matmul"] += 1
        return plain_mm(a, b, c, out_dtype)

    def flash_kernel(*args, **kw):
        launches["flash_carry"] += 1
        return plain_flash(*args, **kw)

    def flash_bwd_kernel(*args, **kw):
        launches["flash_carry_bwd"] += 1
        return plain_bwd(*args, **kw)

    monkeypatch.setattr(sk, "ssd_chunks_cuda", ssd_kernel)
    monkeypatch.setattr(ssd_ops, "ssd_chunks",
                        lambda x, dt, a, b, c, *, nheads, ngroups:
                        sk._SSDChunks.apply(x, dt, a, b, c, nheads, ngroups))
    monkeypatch.setattr(mk, "matmul_cuda", mm_kernel)
    monkeypatch.setattr(mk, "matmul_plain", mm_ops._TileMatmul.apply)
    monkeypatch.setattr(fk, "flash_carry_plain", flash_kernel)
    monkeypatch.setattr(fk, "flash_carry_backward_plain", flash_bwd_kernel)
    return launches


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_ssd_chunks_function_grads_equal_twin(kernel_functions, shift):
    """``_SSDChunks``' gradients in x, dt, a, b and c are the twin's
    autograd bit for bit, also where exp(cum[t] - cum[s]) overflows above
    the diagonal (shift 3: cum reaches about -900 in a chunk of 256),
    where they stay finite."""
    g = torch.Generator().manual_seed(0)
    bh, nc, l, p, n, h = 4, 2, 256 if shift else 16, 8, 8, 2
    x = torch.randn(bh, nc, l, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(bh, nc, l, 1, generator=g)
                                      + shift)
    a = -torch.exp(torch.randn(bh, 1, 1, 1, generator=g) * 0.3)
    b = torch.randn(bh // h, nc, l, n, generator=g) * 0.3
    c = torch.randn(bh // h, nc, l, n, generator=g) * 0.3
    ups = [torch.randn(bh, nc, l, p, generator=g),
           torch.randn(bh, nc, p, n, generator=g),
           torch.randn(bh, nc, l, 1, generator=g)]

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
        outs = fn(*ins)
        return outs, torch.autograd.grad(outs, ins, ups)

    outs, got = grads(lambda *t: sk._SSDChunks.apply(*t, h, 1))
    want_outs, want = grads(lambda *t: sk.ssd_chunks_plain(
        *t, nheads=h, ngroups=1))
    assert kernel_functions["ssd_chunks"] == 1
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w)
    for gt, wt in zip(got, want):
        assert torch.isfinite(gt).all()
        assert torch.equal(gt, wt)


def test_kernel_functions_zamba_grads_and_launches(smoke, kernel_functions):
    """On a ring of 2 in qlr under remat "full" the three Functions'
    backward gives the reference's gradients. A forward launches the SSD
    kernel once per Mamba2 layer, and per super-block the QKV ring's
    tile matmul 3 sinks x 2 hops and the flash hop 2 times. The backward
    recomputes each super-block up to the input of its last Mamba2 layer
    (its shared block and ``inner - 1`` layers: a non-reentrant checkpoint
    stops once every tensor it saved is back), then each Mamba2 layer
    once more for its own checkpoint."""
    cfg = smoke["cfg"]
    model, params = _port(smoke, 2, "qlr", remat="full")
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    with torch.no_grad():
        model.loss(params, batch)
    n_super, inner = cfg.n_shared_attn, cfg.attn_every
    forward = {"ssd_chunks": cfg.num_layers, "tile_matmul": n_super * 3 * 2,
               "flash_carry": n_super * 2, "flash_carry_bwd": 0}
    assert kernel_functions == forward
    for k in kernel_functions:
        kernel_functions[k] = 0
    loss, _, grads = step_lib.value_and_grad(model, params, batch)
    assert float(loss) == pytest.approx(smoke["loss"], abs=LOSS_TOL)
    _assert_grads(grads, smoke["grads"])
    step = {"ssd_chunks": 2 * cfg.num_layers + n_super * (inner - 1),
            "tile_matmul": 2 * forward["tile_matmul"],
            "flash_carry": 2 * forward["flash_carry"],
            "flash_carry_bwd": forward["flash_carry"]}
    assert kernel_functions == step


# ---------------------------------------------------------------------------
# serving: freed slots, lockstep with the reference, the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b",
                                  "mamba2-1.3b", ARCH])
def test_free_slot_zeroes_one_row_of_every_leaf(arch):
    """Every cache leaf with a batch axis loses exactly the freed slot's
    row, found by ``cache_axes()``; all else stays as it was."""
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(0, "cpu")
    scfg = ServeConfig(max_batch=4, max_seq_len=16)
    backend = DecodeBackend(cfg, scfg, params, device="cpu")
    g = torch.Generator().manual_seed(0)
    for leaf in opt.tree_leaves(backend.cache):
        leaf.copy_(torch.randint(1, 9, leaf.shape, generator=g)
                   .to(leaf.dtype))
    before = backend.snapshot_cache()
    backend.free_slot(2)
    axes = backend.model.cache_axes()
    for key, group in backend.cache.items():
        leaves = group if isinstance(group, dict) else {None: group}
        for name, leaf in leaves.items():
            ax = axes[key] if name is None else axes[key][name]
            old = before[key] if name is None else before[key][name]
            if "cache_batch" not in ax:
                assert torch.equal(leaf, old), (key, name)
                continue
            dim = ax.index("cache_batch")
            assert leaf.shape[dim] == 4
            for row in range(4):
                got, was = leaf.select(dim, row), old.select(dim, row)
                if row == 2:
                    assert not got.any(), (key, name)
                else:
                    assert torch.equal(got, was), (key, name, row)


@pytest.mark.parametrize("n_pe,mode", [(0, "dense"), (2, "qlr")])
def test_reused_slot_decodes_like_a_fresh_engine(n_pe, mode, monkeypatch):
    """A request admitted into a slot freed by an earlier one decodes bit
    for bit as in a fresh engine; without the zeroing it would not (the
    Mamba2 states and the attention cache carry the old occupant)."""
    cfg = replace(get_smoke_config(ARCH), dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(3, "cpu")
    scfg = ServeConfig(max_batch=2, max_seq_len=32)
    rng = np.random.default_rng(5)
    first = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)

    def run(prompts):
        backend = RingShardedBackend(cfg, scfg, params, n_pe, mode,
                                     device="cpu") if n_pe \
            else DecodeBackend(cfg, scfg, params, device="cpu")
        engine = ServeEngine(cfg, scfg, params, backend=backend,
                             device="cpu")
        out = []
        for p in prompts:
            engine.sched.submit(p, 5)
            engine._admit()
            assert engine.sched.slot_req[0] is not None
            while engine.sched.busy:
                toks, active, sampling = engine.sched.plan()
                logits = backend.step(toks, active)
                engine.sched.commit(sampling, logits.argmax(-1).numpy())
                if sampling[0]:
                    out.append(logits[0].clone())
        return torch.stack(out[-5:])

    fresh = run([second])
    assert torch.equal(run([first, second]), fresh)
    monkeypatch.setattr(DecodeBackend, "free_slot", lambda self, slot: None)
    assert not torch.equal(run([first, second]), fresh)


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


@pytest.mark.parametrize("n_pe,mode", [(0, "dense"), (2, "qlr"),
                                       (4, "xqueue")])
def test_greedy_serving_matches_reference_engine(reference_run, n_pe, mode):
    """Prompts stream through decode in both engines (no block prefill);
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


def _launch_train(argv):
    from repro_torch.launch import train as launch
    old = signal.getsignal(signal.SIGTERM)
    try:
        return launch.main(argv)
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("arch", ["olmo-1b", ARCH, "mamba2-1.3b"])
def test_train_launcher_smoke(arch, tmp_path, capsys):
    """``--arch ... --smoke`` on the CPU, on a ring of 2 in qlr where the
    model has one (Mamba2 has none: its ``--n-pe`` defaults to 0): the
    losses are finite and the checkpoint restores the state it saved."""
    ring = [] if arch == "mamba2-1.3b" else ["--n-pe", "2"]
    state = _launch_train(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           *ring, "--set", "systolic_mode=qlr",
                           "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"{get_smoke_config(arch).name} [" in out
    assert "done: 2 steps" in out and int(state["opt"]["step"]) == 2
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), async_save=False)
    back = mgr.restore(2, step_lib.init_state(get_smoke_config(arch),
                                              TrainConfig(), 7, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(back),
                                                 opt.tree_leaves(state)))
    assert all(bool(torch.isfinite(t.float()).all())
               for t in opt.tree_leaves(state["params"]))


def test_train_launcher_refuses_a_mamba_ring(tmp_path):
    """An explicit ``--n-pe`` for Mamba2 is refused, not ignored."""
    with pytest.raises(NotImplementedError, match="no ring"):
        _launch_train(["--arch", "mamba2-1.3b", "--smoke", "--device",
                       "cpu", "--steps", "1", "--n-pe", "2",
                       "--ckpt-dir", str(tmp_path)])


def test_serve_launcher_zamba_ring(capsys):
    from repro_torch.launch import serve as launch
    engine, reqs = launch.main(["--arch", ARCH, "--device", "cpu",
                                "--backend", "ring", "--n-pe", "2",
                                "--requests", "5", "--max-new", "4",
                                "--max-batch", "2", "--max-seq", "32"])
    assert all(r.status == "done" and len(r.out_tokens) == 4 for r in reqs)
    assert "ring-qlr" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# checkpoints: Zamba's nested stacks, both ways
# ---------------------------------------------------------------------------


def test_zamba_checkpoints_restore_both_ways(ref, tmp_path):
    from repro.configs import get_smoke_config as r_smoke
    from repro.train import step as rstep
    from repro.train.checkpoint import CheckpointManager as RManager
    cfg, tcfg = get_smoke_config(ARCH), TrainConfig()
    state = step_lib.init_state(cfg, tcfg, 2, "cpu")
    ckpt_lib.CheckpointManager(str(tmp_path / "port"),
                               async_save=False).save(3, state)
    with np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as npz:
        assert npz["params/mamba/mixer/A_log"].shape == (2, 2, 8)
        assert npz["opt/m/tail/norm/scale"].shape == (1, 64)
    target = rstep.init_state(r_smoke(ARCH), tcfg, jax.random.PRNGKey(0))
    got = RManager(str(tmp_path / "port"), async_save=False).restore(
        3, target)
    want = _leaves(state_to_reference(state))
    assert _leaves(got).keys() == want.keys()
    for k, v in _leaves(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    RManager(str(tmp_path / "ref"), async_save=False).save(4, got)
    back = ckpt_lib.CheckpointManager(str(tmp_path / "ref"),
                                      async_save=False).restore(
        4, step_lib.init_state(cfg, tcfg, 9, "cpu"))
    for a, b in zip(opt.tree_leaves(back), opt.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
