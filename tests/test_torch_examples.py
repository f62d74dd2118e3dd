"""The port's examples (``repro_torch.examples``) against the JAX
reference's.

The reference's example scripts import ``repro.compat`` directly and
cannot run on this jax; their steps are replayed here through
``load_reference()`` and its modules, on SMOKE configs in fp32 with the
reference's own weights (``params_from_reference``) and the same numpy
inputs on both sides. Bounds:

- quickstart: the initial loss 1e-4 relative; after one step the loss and
  ``grad_norm`` 1e-4 relative (``tests/test_torch_train.py``'s bounds for
  the reference's ``make_train_step`` on a 1x1 mesh); greedy tokens equal
  but at an fp near-tie of the reference's logits; the ring of 4 in qlr
  equal to no ring within 1e-4;
- serve_batched: every request done; tokens equal, token for token, to
  the reference's dense engine but at a near-tie (``tests/test_torch_serve
  .py``'s rule);
- systolic_topologies: the reference's permutations; the ring matmul and
  the MoE 1e-4 relative, ring attention 1e-5, conv2d 1e-5 of the
  reference's ``conv2d_ref``, the FFT 1e-5 relative to numpy; conv2d and
  the FFT identical in every mode; ``sw`` counting more ops than
  ``xqueue`` and ``qlr``;
- train_lm: the launcher's argument list of the reference's example, and
  a run stopped and resumed equal to one run straight through.
"""
from __future__ import annotations

import json
import re
import runpy
import signal
import sys
from dataclasses import replace
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
)

from repro_torch.configs import get_smoke_config
from repro_torch.examples import (
    quickstart,
    serve_batched,
    systolic_topologies,
    train_lm,
)
from repro_torch.models import params_from_reference

TIE_GAP = 5e-3
EXAMPLES = SRC.parent / "examples"


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _first_divergence(got, want, gaps) -> int | None:
    """Index of the first token where ``got`` leaves ``want``; there the
    reference's top-two gap ``gaps[i]`` must be an fp near-tie."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert gaps[i] < TIE_GAP, (i, a, b, gaps[i])
            return i
    assert len(got) == len(want)
    return None


def _gap(logits) -> float:
    top2 = np.partition(np.asarray(logits, np.float32).ravel(), -2)[-2:]
    return float(top2[1] - top2[0])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

QUICK_ARCHS = ("qwen3-0.6b", "internvl2-1b", "whisper-tiny")


def _quick_batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    b, s = quickstart.BATCH, quickstart.SEQ
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "targets": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((b, cfg.enc_frames, cfg.d_model),
                                   np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.zeros((b, cfg.num_patches, cfg.vit_dim),
                                         np.float32)
    return batch


@pytest.fixture(scope="module", params=QUICK_ARCHS)
def quick(request, ref):
    """The reference example's steps on ``arch``: (port config, reference
    tree, numpy batch, {loss, step_loss, grad_norm, tokens, gaps})."""
    from jax.sharding import AxisType
    from repro.configs import TrainConfig as RTrainConfig
    from repro.train import optimizer as ropt
    from repro.train import step as rstep
    rcfg, cfg = smoke_fp32(request.param)
    rmodel, rparams, tree = reference_model(rcfg)
    batch = _quick_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, _ = jax.jit(rmodel.loss)(rparams, jbatch)
    tcfg = RTrainConfig(learning_rate=1e-3, warmup_steps=0,
                        schedule="constant")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    train_step = jax.jit(rstep.make_train_step(rcfg, tcfg, mesh))
    state = {"params": rparams, "opt": ropt.init_opt_state(rparams, tcfg)}
    state, m = train_step(state, jbatch)
    cache = rmodel.init_cache(1, 32)
    tok = jnp.asarray([[1]], jnp.int32)
    decode = jax.jit(rmodel.decode_step)
    tokens, gaps = [], []
    for _ in range(quickstart.DECODE_TOKENS):
        logits, cache = decode(state["params"], cache, tok)
        gaps.append(_gap(logits[0]))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(int(tok[0, 0]))
    want = {"loss": float(loss), "step_loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "tokens": tokens,
            "gaps": gaps}
    return cfg, tree, batch, want


def _quick_run(cfg, tree, batch, n_pe=0):
    params = params_from_reference(tree, cfg, device="cpu")
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return quickstart.run(cfg, n_pe=n_pe, params=params, batch=tbatch,
                          device="cpu")


def test_quickstart_vs_reference(quick):
    cfg, tree, batch, want = quick
    got = _quick_run(cfg, tree, batch)
    assert _rel(got["loss"], want["loss"]) < 1e-4
    for k in ("step_loss", "grad_norm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k
    assert got["ln_vocab"] == pytest.approx(np.log(cfg.vocab_size))
    _first_divergence(got["tokens"], want["tokens"], want["gaps"])


def test_quickstart_ring_equals_dense(quick):
    cfg, tree, batch, _ = quick
    dense = _quick_run(cfg, tree, batch)
    ring = _quick_run(replace(cfg, systolic_mode="qlr"), tree, batch,
                      n_pe=4)
    for k in ("loss", "step_loss", "grad_norm"):
        assert _rel(ring[k], dense[k]) < 1e-4, k
    assert ring["tokens"] == dense["tokens"]


def test_quickstart_batch_shapes():
    """The default batch: [4, 64] tokens and targets in the vocabulary,
    zero frames or patches in the activation type."""
    for arch in QUICK_ARCHS:
        cfg = get_smoke_config(arch)
        batch = quickstart.make_batch(cfg, "cpu")
        assert batch["tokens"].shape == batch["targets"].shape == (4, 64)
        assert int(batch["tokens"].max()) < cfg.vocab_size
        assert not torch.equal(batch["tokens"], batch["targets"])
        extra = set(batch) - {"tokens", "targets"}
        assert extra == {"encdec": {"frames"}, "vlm": {"patch_embeds"}}.get(
            cfg.family, set())
        for k in extra:
            assert not batch[k].any()


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_serving(ref):
    """The reference's dense ``ServeEngine`` on the example's requests:
    (port config, reference tree, {rid: tokens}, {rid: per-token gaps})."""
    from repro.configs import ServeConfig as RServeConfig
    from repro.serve.engine import ServeEngine as RServeEngine
    rcfg, cfg = smoke_fp32()
    _, rparams, tree = reference_model(rcfg)
    engine = RServeEngine(rcfg, RServeConfig(
        max_batch=4, max_seq_len=serve_batched.MAX_SEQ), rparams)
    gaps: dict[int, list] = {}
    commit = engine._sample_and_commit

    def recording(logits, sampling):
        lg = np.asarray(logits, np.float32)
        for slot, req in enumerate(engine.sched.slot_req):
            if req is not None and sampling[slot]:
                gaps.setdefault(req.rid, []).append(_gap(lg[slot]))
        return commit(logits, sampling)

    engine._sample_and_commit = recording
    for prompt, max_new in serve_batched.requests(cfg.vocab_size, 10):
        engine.submit(prompt, max_new_tokens=max_new)
    reqs = list(engine.pending)
    engine.run()
    assert all(r.done for r in reqs)
    return cfg, tree, {r.rid: list(r.out_tokens) for r in reqs}, gaps


SERVE_CASES = [pytest.param(False, "qlr", id="dense")] + [
    pytest.param(True, mode, id=f"ring-{mode}")
    for mode in ("baseline", "sw", "xqueue", "qlr")]


@pytest.mark.parametrize("ring,mode", SERVE_CASES)
def test_serve_batched_vs_reference_engine(reference_serving, ring, mode):
    cfg, tree, want, gaps = reference_serving
    params = params_from_reference(tree, cfg, device="cpu")
    # SMOKE's 2 KV heads split over a ring of 2
    got = serve_batched.run(cfg, ring=ring, mode=mode, n_pe=2,
                            params=params, device="cpu")
    assert got["done"] == got["requests"] == len(want) == 10
    assert got["backend"] == (f"ring-{mode}" if ring else "dense")
    ties = 0
    for r in got["out"]:
        ties += _first_divergence(r["tokens"], want[r["rid"]],
                                  gaps[r["rid"]]) is not None
    assert ties <= 1
    assert got["tokens"] == sum(len(t) for t in want.values())


def test_serve_batched_requests_follow_the_reference_rng():
    """Prompts of 2-19 tokens and budgets of 4-11, drawn in the
    reference's order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    for prompt, max_new in serve_batched.requests(512, 10):
        want = rng.integers(0, 512, size=int(rng.integers(2, 20)))
        np.testing.assert_array_equal(prompt, want)
        assert max_new == int(rng.integers(4, 12))


# ---------------------------------------------------------------------------
# systolic_topologies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def topo_run(ref):
    """(the port's run on numpy inputs, the inputs, the reference's MoE
    config and parameters)."""
    from repro.configs.mixtral_8x22b import SMOKE as RSMOKE
    from repro.models import moe as rmoe
    from repro.models.common import split_tree
    rcfg = replace(RSMOKE, num_experts=8, dtype="float32",
                   param_dtype="float32")
    mparams, _ = split_tree(rmoe.init_moe(jax.random.PRNGKey(4), rcfg))
    mparams = jax.tree_util.tree_map(np.asarray, mparams)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs = {"x": rand(16, 8), "w": rand(8, 8), "q": rand(1, 32, 2, 8),
              "k": rand(1, 32, 2, 8), "v": rand(1, 32, 2, 8),
              "moe_params": mparams, "moe_x": rand(2, 32, rcfg.d_model),
              "img": rand(64, 32), "kern": rand(3, 3),
              "xs": (rand(8, 4, 256) + 1j * rand(8, 4, 256)).astype(
                  np.complex64)}
    return systolic_topologies.run("cpu", inputs), inputs, rcfg, mparams


def _np(t):
    return t.detach().cpu().numpy()


def test_topologies_match_reference(topo_run, ref):
    from repro.core import topology as rtopo
    want = [rtopo.ring("pe", 8), rtopo.chains("pe", 8, 2),
            rtopo.snake_ring("pe", 2, 4)]
    got = topo_run[0]["topologies"]
    assert [t["name"] for t in got] == [t.name for t in want]
    for g, w in zip(got, want):
        assert [tuple(p) for p in g["perm"]] == [tuple(p) for p in w.perm]
        assert g["links"] == len(w.perm)


def _causal_attention(q, k, v):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = q.shape[1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("mode", systolic_topologies.MODES)
def test_topologies_ring_sections_within_bounds(topo_run, mode, ref):
    from repro.models import moe as rmoe
    out, inp, rcfg, mparams = topo_run
    mm = np.broadcast_to(inp["x"].astype(np.float64) @ inp["w"],
                         (8, 16, 8))
    got = _np(out["matmul"][mode]["value"])
    assert np.abs(got - mm).max() <= 1e-4 * np.abs(mm).max()
    att = _causal_attention(inp["q"], inp["k"], inp["v"])
    assert np.abs(_np(out["attention"][mode]["value"]) - att).max() <= 1e-5
    y_ref, _ = jax.jit(rmoe.apply_moe, static_argnums=2)(
        mparams, jnp.asarray(inp["moe_x"]), rcfg)
    y_ref = np.asarray(y_ref)
    got = _np(out["moe"][mode]["value"])
    assert np.abs(got - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
    for name in ("matmul", "attention", "moe"):
        assert out[name][mode]["rel_err"] <= 1e-4, name


def test_topologies_conv2d_and_fft(topo_run, ref):
    from repro.core.halo import conv2d_ref
    out, inp, _, _ = topo_run
    want = np.asarray(conv2d_ref(jnp.asarray(inp["img"]),
                                 jnp.asarray(inp["kern"])))
    fft_ref = np.fft.fft(inp["xs"], axis=-1)
    for mode in systolic_topologies.MODES:
        assert np.abs(_np(out["conv2d"][mode]["value"]) - want).max() \
            <= 1e-5, mode
        err = np.abs(_np(out["fft"][mode]["value"]) - fft_ref).max()
        assert err <= 1e-5 * np.abs(fft_ref).max(), mode
        assert out["fft"][mode]["rel_err"] <= 1e-5
    assert out["conv2d"]["identical"] and out["fft"]["identical"]


@pytest.mark.parametrize("section", ["matmul", "attention", "moe"])
def test_topologies_sw_counts_more_ops(topo_run, section):
    rec = topo_run[0][section]
    assert rec["sw"]["ops"] > rec["xqueue"]["ops"]
    assert rec["sw"]["ops"] > rec["qlr"]["ops"]
    # the modes launch the same kernels: only the bookkeeping differs
    assert rec["sw"]["launches"] == rec["xqueue"]["launches"] \
        == rec["qlr"]["launches"]


def test_topologies_sections_launch_their_kernels(topo_run):
    out = topo_run[0]
    assert out["matmul"]["qlr"]["launches"] == {"tile_matmul": 8}
    assert out["attention"]["qlr"]["launches"] == {"flash_carry": 8}
    assert out["moe"]["qlr"]["launches"]["tile_matmul"] > 0
    assert out["conv2d"]["qlr"]["launches"] == {"conv2d_3x3": 1}
    # one launch a pipeline tick: 8 microbatches through 4 stages
    assert out["fft"]["qlr"]["launches"] == {"fft_stage": 8 + 4 - 1}


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def _without(argv, *flags):
    """``argv`` without the given flags and their values."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resume"])
def test_train_lm_argv_matches_reference(ref, monkeypatch, full, resume):
    import repro.launch.train as rtrain
    captured = []
    monkeypatch.setattr(rtrain, "main", captured.append)
    monkeypatch.setattr(sys, "argv", ["train_lm.py"]
                        + (["--full"] if full else [])
                        + (["--resume"] if resume else []))
    runpy.run_path(str(EXAMPLES / "train_lm.py"), run_name="__main__")
    (want,) = captured
    got = train_lm.launcher_argv(full, resume, "cpu")
    assert got[-2:] == ["--device", "cpu"]
    assert _without(got, "--ckpt-dir", "--device") == \
        _without(want, "--ckpt-dir")
    assert "repro_torch_train_lm" in got[got.index("--ckpt-dir") + 1]


def _losses(path: Path) -> dict:
    return {r["step"]: r["loss"] for r in map(json.loads,
                                              path.read_text().splitlines())}


def _train(extra):
    old = signal.getsignal(signal.SIGTERM)
    try:
        return train_lm.run(device="cpu", extra=extra)["state"]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_train_lm_resume_gives_the_straight_run(tmp_path):
    def extra(steps, name):
        return ["--steps", str(steps), "--train-set", "checkpoint_every=2",
                "--ckpt-dir", str(tmp_path / name), "--train-set",
                "log_every=1", "--log", str(tmp_path / f"{name}.jsonl")]

    _train(extra(4, "cut"))
    resumed = _train(extra(6, "cut") + ["--resume"])
    straight = _train(extra(6, "straight"))
    cut, whole = _losses(tmp_path / "cut.jsonl"), \
        _losses(tmp_path / "straight.jsonl")
    assert sorted(cut) == sorted(whole) == list(range(6))
    assert cut == whole
    assert int(resumed["opt"]["step"]) == int(straight["opt"]["step"]) == 6
    for a, b in zip(jax.tree_util.tree_leaves(resumed["params"]),
                    jax.tree_util.tree_leaves(straight["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# main(): the reference's line formats, and no CPU fallback
# ---------------------------------------------------------------------------

MODULES = {"quickstart": quickstart, "serve_batched": serve_batched,
           "systolic_topologies": systolic_topologies, "train_lm": train_lm}
NUM = r"-?\d+\.\d+"
FORMATS = {
    "quickstart": [r".*\[dense\] ~.* params",
                   rf"initial loss: {NUM} \(ln V = {NUM}\)",
                   rf"after 1 step: loss={NUM} grad_norm={NUM}",
                   r"greedy tokens: \[(\d+, ){4}\d+\]"],
    "serve_batched": [
        r"10/10 requests \(ring-sw\), \d+ tokens in \d+ ticks "
        rf"\({NUM} tok/s, slot batch 4\)",
        *[rf"  rid= {i} prompt=[ \d]\d -> \[[\d, ]+\]" for i in range(5)]],
    "systolic_topologies": [
        r"topologies over 8 PEs:",
        r"  ring\+1 +links=8 perm=\[\(0, 1\).*\]\.\.\.",
        r"  chains2 +links=6 perm=\[.*\]",
        r"  snake2x4 +links=8 perm=\[.*\]\.\.\.",
        r"ring all-gather matmul \(A streamed, W resident\):",
        r"  baseline  err=\d\.\de[+-]\d\d ops= +\d+ launches= +\d+",
        r"  sw        err=\d\.\de[+-]\d\d ops= +\d+ launches= +\d+  <- "
        r"software-queue bookkeeping overhead",
        r"hybrid conv2d \(halo queues \+ local loads\): err=\d\.\de[+-]\d\d",
        r"4-stage pipelined radix-4 FFT: rel err=\d\.\de[+-]\d\d"],
}
ARGS = {"quickstart": [], "serve_batched": ["--ring", "--mode", "sw",
                                            "--n-pe", "2"],
        "systolic_topologies": []}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_main_prints_reference_formats(name, capsys):
    MODULES[name].main(["--device", "cpu", *ARGS[name]])
    lines = capsys.readouterr().out.splitlines()
    for pattern in FORMATS[name]:
        assert any(re.match(pattern, line) for line in lines), pattern


def test_train_lm_main_runs_the_small_launch(monkeypatch, tmp_path):
    """``main`` hands the launcher the small argument list with the
    checkpoint under the temporary directory; the run is the launcher's,
    cut here to 2 steps."""
    import tempfile
    from repro_torch.launch import train as launch
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []

    def cut(argv):
        seen.append(argv)
        return launch.main(argv + ["--steps", "2"])

    monkeypatch.setattr(train_lm, "train_main", cut)
    old = signal.getsignal(signal.SIGTERM)
    try:
        out = train_lm.main(["--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, old)
    assert seen == [train_lm.launcher_argv(False, False, "cpu")]
    assert int(out["state"]["opt"]["step"]) == 2
    assert (tmp_path / "repro_torch_train_lm").is_dir()


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_refuses_cuda_without_a_gpu(name):
    """The default device is ``cuda``; without a GPU every example
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        MODULES[name].main([])
