"""The port's roofline against the reference: parameter counts, the shape
grid, input specs, model FLOPs, the op-and-kernel counter against
``hlo_parse`` on compiled HLO, kernel launches on the ring paths, the
microbatch multiplier, each kernel's ``work`` against the bounds of
``PERF.md`` §6, and the CUDA wrappers' fake branch.

Counts are exact integers or sums of them, so equalities are exact; the
counter's FLOPs are held within 5% of the reference's ``hlo_parse``.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_torch_reference import ref, smoke_fp32  # noqa: F401 (fixture)

from repro_torch import configs
from repro_torch.configs import ShapeConfig, TrainConfig
from repro_torch.kernels.causal_conv import kernel as cck
from repro_torch.kernels.conv2d import kernel as ck
from repro_torch.kernels.fft import kernel as ffk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.systolic_matmul import kernel as mk
from repro_torch.launch import dryrun
from repro_torch.models import input_specs
from repro_torch.roofline import analysis, count, hw
from repro_torch.train import step as step_lib

ARCHS = configs.ARCHS
KERNELS = (mk.TILE_MATMUL, fk.FLASH_CARRY, fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS,
           sk.SSD_CHUNKS_BWD, ck.CONV2D_3X3, ffk.FFT_STAGE, cck.CAUSAL_CONV,
           cck.CAUSAL_CONV_BWD)


# ---------------------------------------------------------------------------
# configs: parameter counts, the grid, input specs, model FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_summary_equal_reference(ref, arch):
    from repro import configs as rconfigs
    for mine, theirs in ((configs.get_config(arch),
                          rconfigs.get_config(arch)),
                         (configs.get_smoke_config(arch),
                          rconfigs.get_smoke_config(arch))):
        assert mine.n_params == theirs.n_params > 0
        assert mine.n_active_params == theirs.n_active_params > 0
        assert configs.config_summary(mine) == \
            rconfigs.config_summary(theirs)


def test_shape_grid_equal_reference(ref):
    from repro import configs as rconfigs
    assert {k: vars(v) for k, v in configs.SHAPES.items()} == \
        {k: vars(v) for k, v in rconfigs.SHAPES.items()}
    for arch in ARCHS:
        for name in configs.SHAPES:
            assert configs.shape_applicable(
                configs.get_config(arch), configs.get_shape(name)) == \
                rconfigs.shape_applicable(rconfigs.get_config(arch),
                                          rconfigs.get_shape(name))
    cells = list(configs.iter_cells())
    assert cells == list(rconfigs.iter_cells())
    assert len(cells) == 33
    # the spot checks of tests/test_models_smoke.py
    assert ("mamba2-1.3b", "long_500k") in cells
    assert ("mixtral-8x22b", "long_500k") in cells
    assert ("zamba2-1.2b", "long_500k") in cells
    assert ("granite-34b", "long_500k") not in cells
    assert ("deepseek-v2-lite-16b", "long_500k") not in cells
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(ref, arch):
    from repro import configs as rconfigs
    from repro.models.model import input_specs as r_input_specs
    for name in configs.SHAPES:
        cfg = configs.get_config(arch)
        if not configs.shape_applicable(cfg, configs.get_shape(name))[0]:
            continue
        specs, axes = input_specs(cfg, configs.get_shape(name))
        rspecs, raxes = r_input_specs(rconfigs.get_config(arch),
                                      rconfigs.get_shape(name))
        assert axes == raxes, (arch, name)
        assert set(specs) == set(rspecs), (arch, name)
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(rspecs[k].shape), (arch, name, k)
            assert str(v.dtype).removeprefix("torch.") == \
                np.dtype(rspecs[k].dtype).name, (arch, name, k)


def test_model_flops_equal_reference(ref):
    from repro.roofline.analysis import model_flops as r_model_flops
    for arch, name in configs.iter_cells():
        cfg, shape = configs.get_config(arch), configs.get_shape(name)
        meta = {"kind": shape.kind, "global_batch": shape.global_batch,
                "seq_len": shape.seq_len, "n_params": cfg.n_params,
                "n_active_params": cfg.n_active_params}
        assert analysis.model_flops(meta) == r_model_flops(meta) > 0


# ---------------------------------------------------------------------------
# the counter against hlo_parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_counted_flops_match_hlo_parse(ref, arch, kind):
    """SMOKE in fp32 on the dense path (``baseline``), B=2, S=64: the
    counter's FLOPs of one prefill, one decode step against a 64-slot
    cache and one train step (loss, backward under remat "full", AdamW)
    against ``hlo_parse.aggregate`` of the reference's jitted step on a
    1x1 mesh (Auto axes, as ``tests/test_torch_train.py`` builds it).
    Found: equal to the last digit in all six (both count 2·M·N·K per
    product, remat's recompute included); the bound is 5%. The op-
    boundary bytes are 2.3–5.6x the fused HLO's: eager PyTorch writes
    every op's output to memory, where XLA fuses the elementwise ops."""
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import TrainConfig as RTrain
    from repro.roofline import hlo_parse
    from repro.train import step as rstep
    rcfg, cfg = smoke_fp32(arch)
    b, s = 2, 64
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    rshape = RShape("cell", s, b, kind)
    if kind == "train":
        state, _ = rstep.state_shapes(rcfg, RTrain(), mesh)
        batch, _ = rstep.batch_shapes(rcfg, rshape, mesh)
        lowered = jax.jit(rstep.make_train_step(rcfg, RTrain(), mesh)).lower(
            state, batch)
    elif kind == "prefill":
        params, _ = rstep.params_shapes(rcfg, mesh)
        batch, _ = rstep.batch_shapes(rcfg, rshape, mesh)
        lowered = jax.jit(rstep.make_prefill_step(rcfg, mesh)).lower(
            params, batch)
    else:
        params, _ = rstep.params_shapes(rcfg, mesh)
        cache, _ = rstep.cache_shapes(rcfg, rshape, mesh)
        batch, _ = rstep.batch_shapes(rcfg, rshape, mesh)
        lowered = jax.jit(rstep.make_serve_step(rcfg, mesh)).lower(
            params, cache, batch["tokens"], batch["active"])
    want = hlo_parse.aggregate(lowered.compile().as_text())
    got = dryrun.count_cell(cfg, ShapeConfig("cell", s, b, kind),
                            TrainConfig(), 0, "cpu")["counts"]
    assert got["flops_per_device"] == pytest.approx(
        want["flops_per_device"], rel=0.05)
    assert set(got["flops_by_kind"]) == {"fp32"}
    assert got["by_kernel"] == {}
    assert 1.0 < got["hbm_bytes_per_device"] / want[
        "hbm_bytes_per_device"] < 10.0


# ---------------------------------------------------------------------------
# kernel launches on the ring paths
# ---------------------------------------------------------------------------


def ring_expect(cfg, n_pe: int, passes: int = 1, backward: int = 0) -> dict:
    """Launches of one dense-decoder prefill (``passes`` 2: a training step
    under remat "full"), reckoned from the code as ``chip_smoke.py`` does:
    per layer the QKV ring (n hops x 3 sinks, where the heads and KV heads
    split n ways), the FFN rings (AG n x 2, RS n) and n flash hops; with
    ``backward`` passes, the flash backward once per differentiated hop."""
    qkv = 3 * n_pe if (cfg.num_heads % n_pe == 0
                       and cfg.num_kv_heads % n_pe == 0) else 0
    out = {"tile_matmul": passes * cfg.num_layers * (qkv + 3 * n_pe),
           "flash_carry": passes * cfg.num_layers * n_pe}
    if backward:
        out["flash_carry_bwd"] = backward * cfg.num_layers * n_pe
    return out


def _launches(counts) -> dict:
    return {k: v["launches"] for k, v in counts["by_kernel"].items()}


def _hollow_twins(monkeypatch):
    """The twins replaced by outputs of the right shape from no ops."""
    def matmul(a, b, c=None, out_dtype=None):
        return torch.empty(a.shape[0], a.shape[1], b.shape[2],
                           dtype=out_dtype or a.dtype, device=a.device)

    def flash(q, k, v, m, l, acc, *args, normalize=False, out_dtype=None,
              **kw):
        out = torch.empty(acc.shape, device=q.device,
                          dtype=(out_dtype or q.dtype) if normalize
                          else torch.float32)
        return torch.empty_like(m), torch.empty_like(l), out
    monkeypatch.setattr(mk, "matmul_plain", matmul)
    monkeypatch.setattr(fk, "flash_carry_plain", flash)


@pytest.mark.parametrize("n_pe", [2, 4])
def test_ring_launches_as_reckoned_and_twins_muted(monkeypatch, n_pe):
    """qwen3 SMOKE on rings of 2 and 4 in qlr: ``by_kernel``'s launches
    equal the launches reckoned from the code (a prefill; a train step
    under remat "full" recomputes every block once), and the twins' ops
    stay out of ``by_op``: hollow twins leave it as it was."""
    cfg = replace(configs.get_smoke_config("qwen3-0.6b"),
                  systolic_mode="qlr", remat="full")
    prefill = ShapeConfig("cell", 64, 2, "prefill")
    got = dryrun.count_cell(cfg, prefill, TrainConfig(), n_pe, "cpu")
    assert _launches(got["counts"]) == ring_expect(cfg, n_pe)
    train = dryrun.count_cell(cfg, ShapeConfig("cell", 64, 2, "train"),
                              TrainConfig(), n_pe, "cpu")
    assert _launches(train["counts"]) == ring_expect(cfg, n_pe, passes=2,
                                                     backward=1)
    assert train["counts"]["link_bytes"] > got["counts"]["link_bytes"] > 0
    _hollow_twins(monkeypatch)
    hollow = dryrun.count_cell(cfg, prefill, TrainConfig(), n_pe, "cpu")
    assert hollow["counts"]["by_op"] == got["counts"]["by_op"]
    assert hollow["counts"]["by_kernel"] == got["counts"]["by_kernel"]


def test_microbatch_multiplier_equals_full_count():
    """The loop-trip multiplier: a train step of 2 microbatches counted
    once and doubled equals both counted (qwen3 SMOKE, ring of 2)."""
    cfg = replace(configs.get_smoke_config("qwen3-0.6b"),
                  systolic_mode="qlr")
    tcfg = TrainConfig(microbatches=2)
    shape = ShapeConfig("cell", 32, 4, "train")
    counts = []
    for fold in (True, False):
        with FakeTensorMode():
            state = step_lib.state_shapes(cfg, tcfg, "cpu")
            batch, _ = step_lib.batch_shapes(cfg, shape, "cpu")
            step = step_lib.make_train_step(cfg, tcfg, n_pe=2)
            with count.Counter(fold_loops=fold) as c:
                step(state, batch)
        counts.append(c.aggregate())
    folded, full = counts
    assert folded["by_kernel"] == full["by_kernel"]
    assert _launches(full) == ring_expect(cfg, 2, passes=2 * 2, backward=2)
    assert folded["by_op"] == full["by_op"]
    assert folded["hbm_bytes_per_device"] == full["hbm_bytes_per_device"]
    assert folded["link_bytes"] == full["link_bytes"] > 0
    for k, v in full["flops_by_kind"].items():
        assert folded["flops_by_kind"][k] == pytest.approx(v, rel=1e-12)


def test_fold_needs_fake_tensors():
    """On real tensors a folding counter still runs every trip: the
    values stay right."""
    with count.Counter(fold_loops=True):
        assert list(count.trips(3)) == [0, 1, 2]
    assert list(count.trips(3)) == [0, 1, 2]


# ---------------------------------------------------------------------------
# each kernel's work against PERF.md §6
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bound(work):
    flops, moved, kind = work
    ms, by = hw.bound_ms(moved, flops, kind)
    return round(ms, 4), by


def _flash_live(sq: int, bp: int, t: int):
    """Live (query, key) pairs and keys of a causal block at offset 0."""
    return bp * sq * (sq + 1) // 2, bp * t


BF = torch.bfloat16
# kernel -> two (work, the bound of its row in PERF.md §6)
PERF_ROWS = {
    "tile_matmul": [
        (lambda: mk.work(_meta(4, 512, 1024, dtype=BF),
                         _meta(4, 1024, 768, dtype=BF), None, BF),
         (0.0041, "bytes")),
        (lambda: mk.work(_meta(256, 512, 512), _meta(256, 512, 512),
                         _meta(256, 512, 512), torch.float32),
         (1.0257, "operations"))],
    "flash_carry": [
        (lambda: fk.work(
            _meta(32, 64, 16, 128, dtype=BF), _meta(32, 64, 8, 128, dtype=BF),
            _meta(32, 16, 64), _meta(32, 16, 64), _meta(32, 16, 64, 128),
            normalize=True, out_dtype=BF,
            **dict(zip(("pairs", "keys"), _flash_live(64, 32, 64)))),
         (0.0127, "bytes")),
        (lambda: fk.work(
            _meta(32, 256, 16, 128, dtype=BF),
            _meta(32, 256, 8, 128, dtype=BF), _meta(32, 16, 256),
            _meta(32, 16, 256), _meta(32, 16, 256, 128), normalize=True,
            out_dtype=BF,
            **dict(zip(("pairs", "keys"), _flash_live(256, 32, 256)))),
         (0.0507, "bytes"))],
    # the backward at qwen3-0.6b's and zamba2-1.2b's training hops
    "flash_carry_bwd": [
        (lambda: fk.backward_work(
            _meta(32, 256, 16, 128, dtype=BF),
            _meta(32, 256, 8, 128, dtype=BF), _meta(32, 16, 256),
            _meta(32, 16, 256, 128)),
         (0.1214, "bytes")),
        (lambda: fk.backward_work(
            _meta(16, 512, 32, 64, dtype=BF), _meta(16, 512, 32, 64, dtype=BF),
            _meta(16, 32, 512), _meta(16, 32, 512, 64)),
         (0.1427, "bytes"))],
    "ssd_chunks": [
        (lambda: sk.work(_meta(256, 8, 256, 64, dtype=BF),
                         _meta(256, 8, 256, 1), _meta(256, 1, 1, 1),
                         _meta(4, 8, 256, 128, dtype=BF),
                         _meta(4, 8, 256, 128, dtype=BF), nheads=64,
                         ngroups=1),
         (0.0826, "bytes")),
        (lambda: sk.work(_meta(256, 8, 256, 64), _meta(256, 8, 256, 1),
                         _meta(256, 1, 1, 1), _meta(4, 8, 256, 128),
                         _meta(4, 8, 256, 128), nheads=64, ngroups=1),
         (0.2609, "operations"))],
    # the backward at zamba2-1.2b's (N = 64) and mamba2-1.3b's (N = 128)
    # training shapes
    "ssd_chunks_bwd": [
        (lambda: sk.backward_work(_meta(256, 8, 256, 64, dtype=BF),
                                  _meta(256, 8, 256, 1), _meta(256, 1, 1, 1),
                                  _meta(4, 8, 256, 64, dtype=BF),
                                  _meta(4, 8, 256, 64, dtype=BF), nheads=64,
                                  ngroups=1),
         (0.0933, "bytes")),
        (lambda: sk.backward_work(_meta(256, 8, 256, 64, dtype=BF),
                                  _meta(256, 8, 256, 1), _meta(256, 1, 1, 1),
                                  _meta(4, 8, 256, 128, dtype=BF),
                                  _meta(4, 8, 256, 128, dtype=BF), nheads=64,
                                  ngroups=1),
         (0.1045, "bytes"))],
    "conv2d_3x3": [
        (lambda: ck.work(_meta(256, 32, 8192), _meta(256, 1, 8192),
                         _meta(256, 1, 8192), _meta(3, 3)),
         (0.1653, "bytes")),
        (lambda: ck.work(_meta(256, 32, 8192, dtype=BF),
                         _meta(256, 1, 8192, dtype=BF),
                         _meta(256, 1, 8192, dtype=BF), _meta(3, 3, dtype=BF)),
         (0.0826, "bytes"))],
    # mamba2-1.3b's conv: the prefill forward, the training backward
    "causal_conv": [
        (lambda: cck.work(_meta(4, 2048, 4352, dtype=BF),
                          _meta(4, 4352, dtype=BF), _meta(4352, dtype=BF)),
         (0.0426, "bytes"))],
    "causal_conv_bwd": [
        (lambda: cck.backward_work(_meta(8, 2048, 4352, dtype=BF),
                                   _meta(4, 4352, dtype=BF),
                                   _meta(4352, dtype=BF)),
         (0.1277, "bytes"))],
    "fft_stage": [
        (lambda: ffk.full_work(_meta(4096, 256, dtype=torch.complex64),
                               _meta(4, 256, dtype=torch.complex64)),
         (0.0050, "bytes")),
        (lambda: ffk.work(_meta(4, 4096, 256, dtype=torch.complex64),
                          _meta(4, dtype=torch.int32),
                          _meta(4, 256, dtype=torch.complex64)),
         (0.0200, "bytes"))],
}


@pytest.mark.parametrize("name", sorted(PERF_ROWS))
def test_kernel_work_reproduces_perf_bounds(name):
    for work, want in PERF_ROWS[name]:
        assert _bound(work()) == want


def test_flash_work_counts_every_pair_by_default():
    """Without live pairs (a dry run's fake offsets) every Sq x T pair and
    every key of the launch counts."""
    q, k = _meta(8, 64, 16, 128, dtype=BF), _meta(8, 64, 8, 128, dtype=BF)
    m, acc = _meta(8, 16, 64), _meta(8, 16, 64, 128)
    flops, moved, kind = fk.work(q, k, m, m, acc)
    assert flops == 4 * 128 * 16 * 8 * 64 * 64 and kind == "bf16"
    assert moved == fk.work(q, k, m, m, acc, pairs=0, keys=8 * 64)[1]


# ---------------------------------------------------------------------------
# the CUDA wrappers: real tensors launch or raise; fake ones allocate only
# ---------------------------------------------------------------------------


def _wrapper_calls(dev, fake_mode=None):
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    i32 = torch.int32
    c64 = torch.complex64
    return {
        "tile_matmul": (lambda: mk.matmul_cuda(t(2, 5, 16, dtype=BF),
                                               t(2, 16, 8, dtype=BF)),
                        [(2, 5, 8)]),
        "flash_carry": (lambda: fk.flash_carry_cuda(
            t(2, 3, 4, 64, dtype=BF), t(2, 5, 2, 64, dtype=BF),
            t(2, 5, 2, 64, dtype=BF), t(2, 4, 3), t(2, 4, 3),
            t(2, 4, 3, 64), t(2, dtype=i32), t(2, dtype=i32),
            t(2, dtype=i32), causal=True),
            [(2, 4, 3), (2, 4, 3), (2, 4, 3, 64)]),
        "flash_carry_bwd": (lambda: fk.flash_carry_backward_cuda(
            t(2, 3, 4, 64, dtype=BF), t(2, 5, 2, 64, dtype=BF),
            t(2, 5, 2, 64, dtype=BF), t(2, 4, 3), t(2, 4, 3),
            t(2, 4, 3, 64), t(2, dtype=i32), t(2, dtype=i32),
            t(2, dtype=i32), None, t(2, 4, 3), t(2, 4, 3), t(2, 4, 3, 64),
            t(2, 4, 3), t(2, 4, 3), t(2, 4, 3, 64), causal=True),
            [(2, 3, 4, 64), (2, 5, 2, 64), (2, 5, 2, 64), (2, 4, 3),
             (2, 4, 3), (2, 4, 3, 64)]),
        "ssd_chunks": (lambda: sk.ssd_chunks_cuda(
            t(4, 2, 16, 8), t(4, 2, 16, 1), t(4, 1, 1, 1), t(2, 2, 16, 8),
            t(2, 2, 16, 8), nheads=2, ngroups=1),
            [(4, 2, 16, 8), (4, 2, 8, 8), (4, 2, 16, 1)]),
        "ssd_chunks_bwd": (lambda: sk.ssd_chunks_backward_cuda(
            t(4, 2, 16, 8), t(4, 2, 16, 1), t(4, 1, 1, 1), t(2, 2, 16, 8),
            t(2, 2, 16, 8), t(4, 2, 16, 8), t(4, 2, 8, 8), None, nheads=2,
            ngroups=1),
            [(4, 2, 16, 8), (4, 2, 16, 1), (4, 1, 1, 1), (2, 2, 16, 8),
             (2, 2, 16, 8)]),
        "conv2d_3x3": (lambda: ck.conv_cuda(t(4, 3, 16), None, None,
                                            t(3, 3)), [(4, 3, 16)]),
        # x as a strided view of wider rows (the layer's input projection)
        "causal_conv": (lambda: cck.causal_conv_cuda(
            torch.empty_strided((2, 5, 16), (120, 24, 1), dtype=BF,
                                device=dev), t(4, 16, dtype=BF),
            t(16, dtype=BF)), [(2, 5, 16)]),
        "causal_conv_bwd": (lambda: cck.causal_conv_backward_cuda(
            torch.empty_strided((2, 5, 16), (120, 24, 1), dtype=BF,
                                device=dev), t(4, 16, dtype=BF),
            t(16, dtype=BF), t(2, 5, 16, dtype=BF)),
            [(2, 5, 16), (4, 16), (16,)]),
        "fft_stage": (lambda: ffk.stage_cuda(t(2, 3, 16, dtype=c64),
                                             t(2, dtype=i32),
                                             t(2, 16, dtype=c64)),
                      [(2, 3, 16)]),
        "fft_full": (lambda: ffk.fft_full_cuda(t(3, 16, dtype=c64),
                                               t(2, 16, dtype=c64)),
                     [(3, 16)]),
    }


WRAPPERS = sorted(_wrapper_calls("cpu"))


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_raises_for_real_cpu_tensors(name):
    """No fallback: a real CPU tensor handed to a CUDA wrapper raises."""
    call, _ = _wrapper_calls("cpu")[name]
    with pytest.raises(ValueError, match="CUDA device"):
        call()


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_fake_branch_allocates_only(monkeypatch, name):
    """Fake ``cuda`` tensors (a dry run's): outputs of the right shapes on
    the device, no build, no library call, no launch counted."""
    for k in KERNELS:
        monkeypatch.setattr(k, "lib", lambda: pytest.fail("library called"))
    before = {k.name: k.launches for k in KERNELS}
    with FakeTensorMode():
        call, shapes = _wrapper_calls("cuda")[name]
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "cuda" for o in outs)
    assert {k.name: k.launches for k in KERNELS} == before


def test_kernel_hook_records_work_and_mutes_twin():
    """On the CPU a wrapper runs its twin: under a counter that is one
    launch with the kernel's work, and none of the twin's ops."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 8, 16, generator=g)
    b = torch.randn(2, 16, 4, generator=g)
    from repro_torch.kernels.systolic_matmul import ops
    with count.Counter() as c:
        y = ops.tile_matmul(a, b)
    assert torch.equal(y, mk.matmul_plain(a, b))
    flops, moved, _ = mk.work(a, b, None, torch.float32)
    assert c.aggregate()["by_kernel"] == {
        "tile_matmul": {"launches": 1, "flops": flops, "bytes": moved}}
    assert "aten.bmm" not in c.aggregate()["by_op"]
    assert c.aggregate()["flops_per_device"] == flops


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_counter_peak_follows_the_device(device):
    """The peak counts the storages made on the step's device (``cuda``
    follows ``cuda:0``, as fake tensors report it), not the arguments."""
    with FakeTensorMode():
        x = torch.empty(1024, device=device)
        with count.Counter(device=device) as c:
            c.hold(x)
            y = x * 2
            del y
            z = torch.cat([x, x])
        assert z.device.type == device
    assert c.peak_bytes == 2 * 1024 * 4
    assert c.aggregate()["hbm_bytes_per_device"] == 4 * 1024 * 4 + 8 * 1024
