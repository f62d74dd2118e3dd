"""The port's autotuner (``repro_torch.autotune``) against the reference's
``repro.autotune``, and the tuned model paths against hand-set configs.

The reference's own tests (``tests/test_autotune.py``) are ported first:
space gates, the ``Plan`` round trip, the cache ladder and persistence,
zero re-measurement after ``tune``, a total miss, a failing plan ranked
last, ``apply_plan`` and ``tuned_cfg``. Then parity: the plan space (the
reference's kernel plans, less ``baseline`` for the ops a model applies),
the key format and the cache files (random entries from a numpy seed)
read the same in both packages. The committed cache is never written,
and one cache file holds one device's entries. ``link_bytes`` sums ``payload_bytes +
mcast_bytes``; the reference's key filter finds no key and gives 0.0
for the same traffic.

The gates: with a cache holding plan P, ``gqa_forward``, ``gqa_decode``
and ``apply_moe`` under ``autotune=True`` equal, bit for bit, the same
config with P's fields set by hand (SMOKE qwen3-0.6b and mixtral-8x22b,
fp32, a ring of 4), and the reference's dense output within 1e-4 (the
ring-against-dense value bound of ``tests/multidev/check_ring_moe.py``).
``kernel_block`` reaches the QKV, out-projection and expert rings and not
the FFN ring, as in the reference.
"""
from __future__ import annotations

import json
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_reference import (  # noqa: F401 (fixture)
    ref,
    smoke_fp32,
    to_torch,
)
from test_torch_serve import _drive, _schedule

from repro_torch.autotune import (
    Plan,
    TuneCache,
    apply_plan,
    api,
    best_plan,
    candidates,
    make_key,
    measure,
    tune,
    tuned_cfg,
)
from repro_torch.autotune import cache as cache_lib
from repro_torch.autotune.space import (
    BLOCKS,
    CYCLE_TOPOLOGIES,
    DEFAULT_PLAN,
    GATED_OPS,
    MODES,
    OP_TOPOLOGIES,
    TOPOLOGIES,
    default_plan,
)
from repro_torch.configs import ServeConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import collective_matmul as cm
from repro_torch.core import ring_attention as ra
from repro_torch.core import ring_moe as rm
from repro_torch.core import topology as tp
from repro_torch.kernels.systolic_matmul.ops import tile_matmul
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.obs import linkstats
from repro_torch.serve.sharded_cache import RingShardedBackend

N_PE = 4
MK = (("model", 8),)
TOL = 1e-4
OPS = tuple(OP_TOPOLOGIES)


@pytest.fixture
def tuning_cache(tmp_path):
    """The process-wide cache pointed at an empty temporary file for one
    test, and put back afterwards."""
    saved = api._CACHE
    try:
        yield api.set_cache_path(str(tmp_path / "cache.json"))
    finally:
        api._CACHE = saved


# ---------------------------------------------------------------------------
# the reference's tests, on the port's API
# ---------------------------------------------------------------------------


def test_candidates_gates_baseline_to_ring():
    plans = candidates("matmul", 8)
    assert DEFAULT_PLAN in plans
    for p in plans:
        assert p.use_kernel            # the port's rings run their kernels
        if p.mode == "baseline":
            assert p.topology == "ring"


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("op", GATED_OPS)
def test_gated_ops_get_link_mode_plans_only(op, n):
    """A plan a model applies must run the kernels: a ``baseline`` model
    takes the dense path, so the gated ops get no ``baseline`` plan, and
    their sweeps are held against the ring backend's ``qlr/ring``."""
    plans = candidates(op, n, blocks=BLOCKS)
    assert plans and all(p.mode != "baseline" and p.use_kernel
                         for p in plans)
    assert default_plan(op) == Plan("qlr", "ring", 0, True)
    assert default_plan(op) in plans
    assert default_plan("matmul") == DEFAULT_PLAN


def test_candidates_gates_grids_on_fold():
    # 7 PEs fold 1x7: no valid even grid, so no torus2d/cannon_grid
    assert {p.topology for p in candidates("matmul", 7)} == \
        {"ring", "snake_fold"}
    assert {p.topology for p in candidates("matmul", 8)} == set(TOPOLOGIES)


def test_candidates_cycle_ops_never_ride_grids():
    for op in ("moe", "decode", "serve"):
        assert {p.topology for p in candidates(op, 8)} <= \
            set(CYCLE_TOPOLOGIES), op


def test_candidates_blocks_require_kernel():
    plans = candidates("matmul", 8, blocks=(0, 64), kernels=(False, True))
    assert any(p.block == 64 and p.use_kernel for p in plans)
    assert not any(p.block and not p.use_kernel for p in plans)
    assert len(plans) == len(set(plans))


def test_plan_round_trips_through_dict():
    p = Plan(mode="qlr", topology="cannon_grid", block=64, use_kernel=True)
    assert Plan.from_dict(p.to_dict()) == p
    assert p.label() == "qlr/cannon_grid/k64"


def test_cache_exact_then_nearest_then_miss(tmp_path):
    c = TuneCache(str(tmp_path / "c.json"))
    p_small = Plan(mode="qlr", topology="snake_fold", use_kernel=True)
    p_big = Plan(mode="xqueue", topology="torus2d", use_kernel=True)
    c.put("attention", (2, 128, 64), "float32", MK, p_small, us=10.0)
    c.put("attention", (2, 4096, 64), "float32", MK, p_big, us=99.0)
    assert c.lookup("attention", (2, 128, 64), "float32", MK) == p_small
    # nearest in log2 space: 256 is one doubling from 128, four from 4096
    assert c.lookup("attention", (2, 256, 64), "float32", MK) == p_small
    assert c.lookup("attention", (2, 2048, 64), "float32", MK) == p_big
    # rank mismatch never borrows ([M,K] weight vs [B,S,D] activation)
    assert c.lookup("attention", (128, 64), "float32", MK) is None
    # other op / dtype / ring: miss
    assert c.lookup("moe", (2, 128, 64), "float32", MK) is None
    assert c.lookup("attention", (2, 128, 64), "bfloat16", MK) is None
    assert c.lookup("attention", (2, 128, 64), "float32",
                    (("model", 4),)) is None


def test_cache_persists_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    c = TuneCache(path)
    plan = Plan(mode="sw", topology="torus2d", block=64, use_kernel=True)
    c.put("matmul", (2, 128, 64), "float32", MK, plan, us=42.0, bytes=7.0)
    c.save()
    c2 = TuneCache(path)
    assert len(c2) == 1 and c2.device is None
    assert c2.get_exact("matmul", (2, 128, 64), "float32", MK) == plan
    key = make_key("matmul", (2, 128, 64), "float32", MK)
    assert key == "matmul|2x128x64|float32|model=8"
    assert c2.entries[key]["us"] == 42.0
    # the card's name travels with the entries; the layout is otherwise
    # the reference's
    c2.device = "NVIDIA H100 80GB HBM3, 700.00 W"
    c2.save()
    data = json.loads((tmp_path / "cache.json").read_text())
    assert set(data) == {"device", "entries", "version"}
    assert TuneCache(path).device == c2.device


def _toy_build(plan: Plan):
    x = torch.arange(8.0)
    if plan.mode == "sw":                       # one deliberately bad plan
        return lambda v: torch.tanh(v @ torch.outer(v, v)).sum(), (x,)
    return lambda v: (v * 2.0).sum(), (x,)


def test_tune_persists_winner_and_exact_hit_runs_no_trials(tmp_path):
    cache = TuneCache(str(tmp_path / "c.json"))
    plans = [Plan(mode=m, use_kernel=True) for m in ("qlr", "sw",
                                                      "baseline")]
    measure.reset_trials()
    winner, results = tune("matmul", (8,), "float32", 8, _toy_build,
                           cache=cache, plans=plans, iters=1)
    assert measure.trial_count() == len(plans)
    assert winner in plans
    assert set(results) == {p.label() for p in plans}
    assert len(cache) == 1 and len(TuneCache(cache.path)) == 1

    measure.reset_trials()
    assert best_plan("matmul", (8,), "float32", 8, cache=cache) == winner
    assert measure.trial_count() == 0           # answered from the cache
    # nearest-shape hits are also measurement-free
    assert best_plan("matmul", (16,), "float32", 8, cache=cache) == winner
    assert measure.trial_count() == 0


def test_best_plan_total_miss_returns_none(tmp_path):
    cache = TuneCache(str(tmp_path / "c.json"))
    assert best_plan("moe", (8,), "float32", 8, cache=cache) is None


def test_tune_ranks_failing_plan_last(tmp_path):
    cache = TuneCache(str(tmp_path / "c.json"))

    def build(plan):
        if plan.mode == "xqueue":
            raise RuntimeError("inapplicable")
        return lambda v: v + 1.0, (torch.ones(4),)

    good, bad = Plan(mode="qlr", use_kernel=True), \
        Plan(mode="xqueue", use_kernel=True)
    winner, results = tune("matmul", (4,), "float32", 8, build, cache=cache,
                           plans=[good, bad], iters=1)
    assert winner == good
    assert results[bad.label()]["us"] == float("inf")
    assert results[bad.label()]["error"] == "RuntimeError: inapplicable"


def test_apply_plan_rewrites_the_fields():
    cfg = ModelConfig(name="t", family="dense")
    plan = Plan(mode="xqueue", topology="torus2d", block=128,
                use_kernel=True)
    out = apply_plan(cfg, plan)
    assert (out.systolic_mode, out.systolic_topology, out.kernel_block) == \
        ("xqueue", "torus2d", 128)
    assert cfg.systolic_mode == "baseline"      # original untouched


def test_tuned_cfg_cache_hit_and_miss(tuning_cache):
    cfg = ModelConfig(name="t", family="dense", autotune=True)
    # miss: defaults stand
    assert tuned_cfg(cfg, "attention", (2, 128, 64), 8) == cfg
    # hit: the cached plan's fields are applied
    plan = Plan(mode="qlr", topology="snake_fold", block=64, use_kernel=True)
    tuning_cache.put("attention", (2, 128, 64), cfg.dtype, api.mesh_key(8),
                     plan)
    out = tuned_cfg(cfg, "attention", (2, 128, 64), 8)
    assert (out.systolic_mode, out.systolic_topology, out.kernel_block) == \
        ("qlr", "snake_fold", 64)
    # gate off: no lookup at all
    cfg_off = replace(cfg, autotune=False)
    assert tuned_cfg(cfg_off, "attention", (2, 128, 64), 8) == cfg_off


# ---------------------------------------------------------------------------
# deliberate differences
# ---------------------------------------------------------------------------


def test_apply_plan_refuses_the_plain_consume():
    plan = Plan(mode="qlr", topology="ring", use_kernel=False)
    with pytest.raises(ValueError, match="qlr/ring/jnp"):
        apply_plan(ModelConfig(name="t"), plan)


@pytest.mark.parametrize("block", [96, 32, -64, 256])
def test_tile_matmul_refuses_other_blocks(block):
    x, w = torch.ones(2, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="block"):
        tile_matmul(x, w, block=block)


@pytest.mark.parametrize("block", BLOCKS)
def test_tile_matmul_block_is_ignored_by_the_plain_version(block):
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 3, 16, generator=g), torch.randn(4, 16, 8,
                                                           generator=g)
    acc = torch.randn(4, 3, 8, generator=g)
    assert torch.equal(tile_matmul(x, w, acc, block=block),
                       tile_matmul(x, w, acc))


def test_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(cache_lib.ENV_PATH, raising=False)
    assert cache_lib.default_path() == str(cache_lib.DEFAULT_FILE)
    assert cache_lib.DEFAULT_FILE.name == "AUTOTUNE_CACHE_H100.json"
    assert cache_lib.DEFAULT_FILE.parent.name == "autotune"
    monkeypatch.setenv(cache_lib.ENV_PATH, str(tmp_path / "x.json"))
    assert cache_lib.default_path() == str(tmp_path / "x.json")


def test_committed_cache_holds_kernel_plans_for_the_card():
    """The committed cache, where present, was measured on a card it names
    and holds kernel plans only, and only link-mode plans for the ops a
    model applies (a ``baseline`` one would run the dense path)."""
    if not cache_lib.DEFAULT_FILE.exists():
        pytest.skip("no tuning cache committed yet")
    c = TuneCache(str(cache_lib.DEFAULT_FILE))
    assert c.device and "H100" in c.device
    assert len(c) >= 8
    for key, e in c.entries.items():
        plan = Plan.from_dict(e["plan"])
        assert plan.use_kernel and plan.block in BLOCKS, key
        assert e["us"] > 0, key
        if cache_lib._parse_key(key)[0] in GATED_OPS:
            assert plan.mode != "baseline", key


@pytest.fixture
def no_global_cache(monkeypatch):
    """No process-wide cache loaded and no cache path in the environment:
    the default is the committed file."""
    monkeypatch.delenv(cache_lib.ENV_PATH, raising=False)
    saved = api._CACHE
    api._CACHE = None
    try:
        yield
    finally:
        api._CACHE = saved


@pytest.mark.parametrize("entry", ["tune", "best_plan", "save"])
def test_the_committed_cache_is_never_written(no_global_cache, entry):
    """A sweep with no cache of its own refuses the committed file before
    any trial, and so does a direct save into it."""
    before = cache_lib.DEFAULT_FILE.read_bytes() \
        if cache_lib.DEFAULT_FILE.exists() else None
    measure.reset_trials()
    with pytest.raises(ValueError, match="committed"):
        if entry == "tune":
            tune("matmul", (8,), "float32", 8, _toy_build, iters=1)
        elif entry == "best_plan":
            # a key the committed file cannot answer, not even by shape
            best_plan("decode", (3, 5, 7), "float16", 8, allow_tune=True,
                      build=_toy_build, iters=1)
        else:
            TuneCache(str(cache_lib.DEFAULT_FILE)).save()
    assert measure.trial_count() == 0
    after = cache_lib.DEFAULT_FILE.read_bytes() \
        if cache_lib.DEFAULT_FILE.exists() else None
    assert after == before


def test_tune_writes_the_cache_the_environment_names(no_global_cache,
                                                     monkeypatch, tmp_path):
    path = tmp_path / "env.json"
    monkeypatch.setenv(cache_lib.ENV_PATH, str(path))
    winner, _ = tune("matmul", (8,), "float32", 8, _toy_build, iters=1,
                     plans=[Plan("qlr", use_kernel=True)], device="card A")
    saved = TuneCache(str(path))
    assert saved.device == "card A"
    assert saved.get_exact("matmul", (8,), "float32", api.mesh_key(8)) == \
        winner


def test_cache_refuses_to_mix_devices(tmp_path):
    plan = Plan("qlr", use_kernel=True)
    a = TuneCache(str(tmp_path / "a.json"))
    a.put("matmul", (8,), "float32", MK, plan, device="card A", us=1.0)
    a.put("matmul", (16,), "float32", MK, plan, device="card A", us=2.0)
    for other in ("card B", None):
        with pytest.raises(ValueError, match="two devices"):
            a.put("matmul", (32,), "float32", MK, plan, device=other)
    assert len(a) == 2 and a.device == "card A"
    a.save()
    b = TuneCache(str(tmp_path / "b.json"))
    b.put("moe", (8,), "float32", MK, plan, device="card B", us=3.0)
    with pytest.raises(ValueError, match="two devices"):
        b.load(a.path)
    assert len(b) == 1
    # a sweep names its device on every entry it writes
    with pytest.raises(ValueError, match="two devices"):
        tune("matmul", (8,), "float32", 8, _toy_build, cache=a, iters=1,
             plans=[plan], device="card B")


def test_time_fn_needs_a_warmup_call():
    with pytest.raises(ValueError, match="warmup"):
        measure.time_fn(lambda: torch.ones(1), warmup=0)


# ---------------------------------------------------------------------------
# parity with the reference: plan space, keys, cache files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", [(0,), BLOCKS], ids=["block0", "blocks"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_candidates_equal_reference_kernel_plans(ref, op, n, blocks):
    """The reference's kernel plans in its order, less ``baseline`` for
    the ops a model applies (the port's deliberate difference)."""
    from repro.autotune import space as rspace
    want = [p.to_dict() for p in rspace.candidates(op, n, blocks=blocks,
                                                   kernels=(True,))
            if not (op in GATED_OPS and p.mode == "baseline")]
    assert [p.to_dict() for p in candidates(op, n, blocks=blocks)] == want


def test_space_constants_equal_reference(ref):
    from repro.autotune import space as rspace
    from repro.autotune.api import NOISE
    assert (rspace.MODES, rspace.TOPOLOGIES, rspace.CYCLE_TOPOLOGIES,
            rspace.BLOCKS, rspace.OP_TOPOLOGIES) == (
        MODES, TOPOLOGIES, CYCLE_TOPOLOGIES,
        BLOCKS, OP_TOPOLOGIES)
    assert api.NOISE == NOISE
    # the reference's default is its jnp consume; the port's the kernel
    assert rspace.DEFAULT_PLAN.to_dict() == dict(DEFAULT_PLAN.to_dict(),
                                                 use_kernel=False)
    for p in rspace.candidates("matmul", 8, blocks=BLOCKS):
        assert Plan.from_dict(p.to_dict()).label() == p.label()


@pytest.mark.parametrize("op,shape,dtype,mesh", [
    ("matmul", (2, 128, 64), "float32", (("model", 8),)),
    ("serve", (8, 64, 64), "float32", (("data", 2), ("model", 4))),
    ("moe", (2, 8192, 6144), "bfloat16", (("model", 8),)),
    ("decode", (), "bfloat16", (("model", 4),)),
])
def test_make_key_equals_reference(ref, op, shape, dtype, mesh):
    from repro.autotune import cache as rcache
    key = make_key(op, shape, dtype, mesh)
    assert key == rcache.make_key(op, shape, dtype, mesh)
    assert cache_lib._parse_key(key) == rcache._parse_key(key)


def _random_entries(rng, n_entries: int):
    """[(op, shape, dtype, mesh, plan dict, us, bytes)] from a seed."""
    from repro.autotune import space as rspace
    out = []
    for _ in range(n_entries):
        op = OPS[rng.integers(len(OPS))]
        shape = tuple(int(2 ** rng.integers(1, 13))
                      for _ in range(int(rng.integers(2, 4))))
        dtype = ("float32", "bfloat16")[rng.integers(2)]
        mesh = (("model", int((2, 4, 8)[rng.integers(3)])),)
        plans = rspace.candidates(op, mesh[0][1], blocks=BLOCKS,
                                  kernels=(False, True))
        plan = plans[rng.integers(len(plans))].to_dict()
        out.append((op, shape, dtype, mesh, plan,
                    float(rng.uniform(1, 1e4)), float(rng.integers(0, 1e6))))
    return out


def _random_queries(rng, n_queries: int):
    out = []
    for _ in range(n_queries):
        out.append((OPS[rng.integers(len(OPS))],
                    tuple(int(rng.integers(1, 5000))
                          for _ in range(int(rng.integers(2, 4)))),
                    ("float32", "bfloat16")[rng.integers(2)],
                    (("model", int((2, 4, 8)[rng.integers(3)])),)))
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_files_read_the_same_in_both_packages(ref, tmp_path, seed,
                                                    writer):
    """One package writes random entries; both read the file and give the
    same exact, nearest and missed lookups; both write it byte for byte
    alike."""
    from repro.autotune import cache as rcache
    from repro.autotune import space as rspace
    rng = np.random.default_rng(seed)
    entries = _random_entries(rng, 40)
    path = str(tmp_path / "cache.json")
    write = rcache.TuneCache(path) if writer == "reference" \
        else TuneCache(path)
    plan_cls = rspace.Plan if writer == "reference" else Plan
    for op, shape, dtype, mesh, plan, us, nbytes in entries:
        write.put(op, shape, dtype, mesh, plan_cls.from_dict(plan), us=us,
                  bytes=nbytes)
    write.save()
    rc, pc = rcache.TuneCache(path), TuneCache(path)
    assert rc.entries == pc.entries

    queries = [(op, shape, dtype, mesh)
               for op, shape, dtype, mesh, *_ in entries[:10]]
    queries += _random_queries(rng, 60)
    kinds = set()
    for q in queries:
        want, got = rc.lookup(*q), pc.lookup(*q)
        assert (got is None) == (want is None), q
        if want is not None:
            assert got.to_dict() == want.to_dict(), q
            kinds.add("exact" if rc.get_exact(*q) is not None
                      else "nearest")
        else:
            kinds.add("miss")
    assert kinds == {"exact", "nearest", "miss"}

    rc.save(str(tmp_path / "ref.json"))
    pc.save(str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()


def test_reference_cache_with_a_data_axis_never_matches(ref):
    """The reference's committed cache reads in the port, but its ``serve``
    entry is keyed on a (data, model) mesh that no ring size names."""
    from test_torch_reference import SRC
    c = TuneCache(str(SRC.parent / "AUTOTUNE_CACHE.json"))
    assert len(c) == 4
    assert c.lookup("serve", (8, 64, 64), "float32",
                    (("data", 2), ("model", 4))) is not None
    for n in (1, 2, 4, 8):
        assert best_plan("serve", (8, 64, 64), "float32", n,
                         cache=c) is None


# ---------------------------------------------------------------------------
# link bytes: what the reference's docstring says it sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["baseline", "sw", "xqueue", "qlr"])
def test_link_bytes_sums_payload_and_multicast(ref, mode):
    from repro.autotune import measure as rmeasure
    from repro.core import collective_matmul as rcm
    from repro.core.topology import ring as rring
    from repro.obs import linkstats as rls
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_PE, 2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((N_PE, 16, 8)).astype(np.float32)

    def port_fn(a, b):
        return cm.ring_ag_matmul(a, [b], tp.ring("model", N_PE), mode)[0]

    with linkstats.collect(1) as sc:
        port_fn(torch.from_numpy(x), torch.from_numpy(w))
    counted = sc.stats.payload_bytes + sc.stats.mcast_bytes
    got = measure.link_bytes(port_fn, torch.from_numpy(x),
                             torch.from_numpy(w))
    assert got == counted > 0

    # the reference, per PE under vmap: its scope counts the same traffic
    # (one PE's share), its link_bytes finds no "bytes*" key and says 0.0
    ref_fn = jax.vmap(lambda a, b: rcm.ring_ag_matmul(
        a, [b], rring("model", N_PE), mode)[0], axis_name="model")
    with rls.collect(1) as rsc:
        ref_fn(jnp.asarray(x), jnp.asarray(w))
    per_pe = rsc.stats.as_dict()
    assert N_PE * (per_pe["payload_bytes"] + per_pe["mcast_bytes"]) == got
    assert rmeasure.link_bytes(ref_fn, jnp.asarray(x), jnp.asarray(w)) == 0.0


def test_tune_prefers_fewer_link_bytes_within_noise(tmp_path):
    """Two plans equal in time (within NOISE): the one that moves fewer
    queue bytes wins, as it never does in the reference."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(N_PE, 2, 8, 16, generator=g)
    w = torch.randn(N_PE, 16, 8, generator=g)

    def build(plan):
        # the xqueue plan streams twice the rows: twice the link bytes
        xs = torch.cat([x, x], dim=-2) if plan.mode == "xqueue" else x
        topo = tp.ring("model", N_PE)
        return (lambda a, b: cm.ring_ag_matmul(a, [b], topo, plan.mode)[0],
                (xs, w))

    more, fewer = Plan(mode="xqueue", use_kernel=True), \
        Plan(mode="qlr", use_kernel=True)
    cache = TuneCache(str(tmp_path / "c.json"))
    winner, results = tune("matmul", (2, 32, 16), "float32", N_PE, build,
                           cache=cache, plans=[more, fewer], iters=1,
                           noise=float("inf"))
    assert results[more.label()]["bytes"] == \
        2 * results[fewer.label()]["bytes"] > 0
    assert winner == fewer
    assert cache.entries[make_key("matmul", (2, 32, 16), "float32",
                                  api.mesh_key(N_PE))]["bytes"] == \
        results[fewer.label()]["bytes"]


# ---------------------------------------------------------------------------
# the gates and the block knob in the models
# ---------------------------------------------------------------------------

# plans the gates apply in the tests below: link modes (the gate turns a
# baseline config's rings on), every topology family, every block
ATTN_PLANS = [Plan("qlr", "ring", 64, True), Plan("xqueue", "snake_fold",
                                                  128, True),
              Plan("sw", "torus2d", 0, True), Plan("qlr", "cannon_grid",
                                                   128, True)]
CYCLE_PLANS = [Plan("qlr", "ring", 128, True), Plan("xqueue", "snake_fold",
                                                    64, True),
               Plan("sw", "ring", 0, True)]


def _cfgs(arch: str, **kw):
    """(reference, port) SMOKE configs in fp32 with ``kw`` applied."""
    rcfg, cfg = smoke_fp32(arch)
    return replace(rcfg, **kw), replace(cfg, **kw)


def _attn_params(cfg, seed=0):
    return attn.init_gqa(torch.Generator().manual_seed(seed), cfg)


def _jax(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def _spy_blocks(monkeypatch):
    """Record the ``block`` of every ring consume: the collective-matmul
    rings' (``cm``) and the expert ring's."""
    seen = {"cm": [], "expert": []}
    real_cm, real_rm = cm.tile_matmul, rm.tile_matmul

    def cm_spy(x, w, acc=None, block=0):
        seen["cm"].append(block)
        return real_cm(x, w, acc, block=block)

    def rm_spy(x, w, acc=None, block=0):
        seen["expert"].append(block)
        return real_rm(x, w, acc, block=block)

    monkeypatch.setattr(cm, "tile_matmul", cm_spy)
    monkeypatch.setattr(rm, "tile_matmul", rm_spy)
    return seen


@pytest.mark.parametrize("plan", ATTN_PLANS, ids=Plan.label)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_gqa_forward_tuned_equals_hand_set(ref, tuning_cache, arch, plan):
    from repro.models import attention as rattn
    # 4 KV heads so that the QKV ring, not only ring attention, engages
    rcfg, cfg = _cfgs(arch, num_kv_heads=4)
    params = _attn_params(cfg)
    x = to_torch(np.random.default_rng(1).standard_normal((2, 32, 64)))
    tuning_cache.put("attention", x.shape, "float32", api.mesh_key(N_PE),
                     plan)
    tuned = replace(cfg, autotune=True)                    # baseline mode
    with torch.no_grad():
        got = attn.gqa_forward(params, x, tuned, n_pe=N_PE)
        hand = attn.gqa_forward(params, x, apply_plan(cfg, plan), n_pe=N_PE)
        dense = attn.gqa_forward(params, x, cfg, n_pe=N_PE)
    assert torch.equal(got, hand)
    want = rattn.gqa_forward(_jax(params), jnp.asarray(x.numpy()), rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_baseline_config_turns_its_rings_on_through_the_cache(
        tuning_cache, monkeypatch):
    """A cached link-mode plan turns a baseline config's QKV ring and ring
    attention on (launches of the two ring families), with the plan's
    block; without the gate, or on a miss, the dense path runs."""
    _, cfg = _cfgs("qwen3-0.6b", num_kv_heads=4)
    params = _attn_params(cfg)
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(2))
    calls = []
    real = ra.systolic_ring_attention
    monkeypatch.setattr(ra, "systolic_ring_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    seen = _spy_blocks(monkeypatch)
    tuned = replace(cfg, autotune=True)
    with torch.no_grad():
        attn.gqa_forward(params, x, tuned, n_pe=N_PE)          # miss
        assert not calls and not seen["cm"]
        tuning_cache.put("attention", x.shape, "float32",
                         api.mesh_key(N_PE), Plan("xqueue", "ring", 64, True))
        attn.gqa_forward(params, x, tuned, n_pe=N_PE)          # hit
        assert len(calls) == 1 and seen["cm"] == [64] * 3 * N_PE
        attn.gqa_forward(params, x, tuned, n_pe=0)      # no ring: no gate
        attn.gqa_forward(params, x, cfg, n_pe=N_PE)     # autotune off
    assert len(calls) == 1 and len(seen["cm"]) == 3 * N_PE


@pytest.mark.parametrize("plan", CYCLE_PLANS, ids=Plan.label)
def test_gqa_decode_tuned_equals_hand_set(ref, tuning_cache, plan):
    from repro.models import attention as rattn
    rcfg, cfg = _cfgs("qwen3-0.6b")
    params = _attn_params(cfg, seed=3)
    rng = np.random.default_rng(4)
    b, s_cache = 4, 16
    x = to_torch(rng.standard_normal((b, 1, 64)))
    kv = [to_torch(rng.standard_normal((b, s_cache, cfg.num_kv_heads, 16)))
          for _ in range(2)]
    pos = torch.tensor([3, 0, 9, 15], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    tuning_cache.put("decode", x.shape, "float32", api.mesh_key(N_PE), plan)

    def run(c, n_pe):
        cache = {"k": kv[0].clone(), "v": kv[1].clone(), "pos": pos.clone()}
        with torch.no_grad():
            return attn.gqa_decode(params, x, cache, c, active, n_pe=n_pe)

    y, cache = run(replace(cfg, autotune=True), N_PE)
    y_hand, cache_hand = run(apply_plan(cfg, plan), N_PE)
    assert torch.equal(y, y_hand)
    for k in cache:
        assert torch.equal(cache[k], cache_hand[k])
    ry, rcache = rattn.gqa_decode(
        _jax(params), jnp.asarray(x.numpy()),
        {"k": jnp.asarray(kv[0].numpy()), "v": jnp.asarray(kv[1].numpy()),
         "pos": jnp.asarray(pos.numpy())}, rcfg,
        active=jnp.asarray(active.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(rcache["pos"]))


@pytest.mark.parametrize("plan", CYCLE_PLANS, ids=Plan.label)
def test_apply_moe_tuned_equals_hand_set(ref, tuning_cache, monkeypatch,
                                         plan):
    from repro.models import moe as rmoe
    rcfg, cfg = _cfgs("mixtral-8x22b")
    p = moe_lib.init_moe(torch.Generator().manual_seed(5), cfg)
    x = to_torch(np.random.default_rng(6).standard_normal((2, 32, 64)))
    tuning_cache.put("moe", x.shape, "float32", api.mesh_key(N_PE), plan)
    seen = _spy_blocks(monkeypatch)
    with torch.no_grad():
        y, aux = moe_lib.apply_moe(p, x, replace(cfg, autotune=True), N_PE)
        assert seen["expert"] == [plan.block] * 3      # the expert ring ran
        y_hand, aux_hand = moe_lib.apply_moe(p, x, apply_plan(cfg, plan),
                                             N_PE)
    assert torch.equal(y, y_hand) and torch.equal(aux, aux_hand)
    ry, raux = rmoe.apply_moe(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        jnp.asarray(x.numpy()), rcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL, atol=TOL)
    assert float(aux) == pytest.approx(float(raux), rel=1e-6)


def test_kernel_block_reaches_qkv_out_proj_and_expert_rings_not_ffn(
        monkeypatch):
    """As in the reference: ``cfg.kernel_block`` reaches the QKV ring, the
    out-projection ring and the expert ring; the FFN ring keeps the
    kernel's own tile."""
    _, cfg = _cfgs("qwen3-0.6b", num_kv_heads=4)
    cfg = replace(cfg, systolic_mode="qlr", kernel_block=128)
    seen = _spy_blocks(monkeypatch)
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(7))
    # the out-projection ring runs where ring attention does not apply
    monkeypatch.setattr(ra, "ring_attn_applicable", lambda *a: False)
    with torch.no_grad():
        attn.gqa_forward(_attn_params(cfg), x, cfg, n_pe=N_PE)
    # the QKV ring's 3 sinks a hop, then the out-projection's n consumes
    assert seen["cm"] == [128] * 4 * N_PE
    seen["cm"].clear()
    mlp = {k: torch.randn(*s, generator=torch.Generator().manual_seed(8))
           for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                        ("w_down", (128, 64)))}
    with torch.no_grad():
        transformer._maybe_systolic_mlp(mlp, x, cfg, N_PE)
    assert seen["cm"] == [0] * 3 * N_PE            # gate and up, then down
    _, mcfg = _cfgs("mixtral-8x22b")
    mcfg = replace(mcfg, systolic_mode="xqueue", kernel_block=64)
    p = moe_lib.init_moe(torch.Generator().manual_seed(9), mcfg)
    with torch.no_grad():
        moe_lib.apply_moe(p, x, mcfg, N_PE)
    assert seen["expert"] == [64] * 3


@pytest.mark.parametrize("block", BLOCKS)
def test_ring_wrappers_pass_the_block_to_every_consume(monkeypatch, block):
    seen = _spy_blocks(monkeypatch)
    g = torch.Generator().manual_seed(10)
    a = torch.randn(4, 8, 8, generator=g)
    b = torch.randn(4, 8, 8, generator=g)
    left, up = cm.cannon_topologies("pe", 2, 2)
    got = cm.cannon_matmul(a, b, left, up, 2, 2, "qlr", block=block)
    assert seen["cm"] == [block] * 2                 # one launch a step
    assert torch.allclose(got, cm.cannon_matmul(a, b, left, up, 2, 2, "qlr"))


@pytest.mark.parametrize("plan", CYCLE_PLANS, ids=Plan.label)
def test_ring_backend_with_a_plan_serves_like_hand_set(plan):
    _, cfg = _cfgs("qwen3-0.6b")
    params = build_model(cfg).init(0, device="cpu")
    scfg = ServeConfig(max_batch=4, max_seq_len=32, temperature=0.0,
                       prefill_chunk=8)
    tuned = RingShardedBackend(cfg, scfg, params, N_PE, mode="baseline",
                               plan=plan, device="cpu")
    hand = RingShardedBackend(
        replace(cfg, systolic_topology=plan.topology,
                kernel_block=plan.block), scfg, params, N_PE, plan.mode,
        device="cpu")
    assert tuned.name == f"ring-{plan.mode}+tuned"
    assert tuned.mode == plan.mode and tuned.cfg == hand.cfg
    from repro_torch.serve.engine import ServeEngine

    def tokens(backend):
        eng = ServeEngine(cfg, scfg, params, backend=backend, device="cpu")
        record = _drive(eng, _schedule(cfg.vocab_size),
                        lambda t: t.numpy().astype(np.float32))
        return [np.asarray(r[2]).tolist() for r in record]

    got = tokens(tuned)
    assert got == tokens(hand) and len(got) > 10
