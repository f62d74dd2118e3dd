"""The frozen yardstick against the port as it stands: each kernel's work
formula equal to the port's ``work`` at the cells' shapes, the live causal
pairs of a ring hop equal to the port's key mask, the peaks equal to
``roofline/hw.py``, the model-FLOP weights equal to a count of the port's
parameter tree; and the trace reading on a made-up timeline."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import bench, flops, kernel_names, peaks, trace
from perfbench.work import flash_carry, flash_carry_bwd, ssd_chunks, \
    ssd_chunks_bwd

BF16, F32 = torch.bfloat16, torch.float32
CELL_SHAPES = {"mamba2-1.3b.train": (8, 2048), "mamba2-1.3b.prefill": (4, 2048)}


def _model(cell_name):
    return bench.load_cell(cell_name).config["model"]


def _ssd_operands(s):
    m = lambda *shape, dt=BF16: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    return (m(s["bh"], s["nc"], s["l"], s["p"]),
            m(s["bh"], s["nc"], s["l"], 1, dt=F32), m(s["bh"], 1, 1, 1, dt=F32),
            m(s["bg"], s["nc"], s["l"], s["n"]),
            m(s["bg"], s["nc"], s["l"], s["n"]))


@pytest.mark.parametrize("cell_name", list(CELL_SHAPES))
def test_ssd_work_equals_the_ports(cell_name):
    from repro_torch.kernels.ssd import kernel as sk
    model = _model(cell_name)
    s = ssd_chunks.shape(model, *CELL_SHAPES[cell_name])
    heads = s["bh"] // CELL_SHAPES[cell_name][0]
    ops = dict(nheads=heads, ngroups=model["ssm_ngroups"])
    args = _ssd_operands(s)
    assert ssd_chunks.work(**s) == sk.work(*args, **ops)[:2]
    assert ssd_chunks_bwd.work(**s) == sk.backward_work(*args, **ops)[:2]


def _ring_offsets(n_pe, batch, sq, hop):
    """The port's ring: PE d holds at hop ``hop`` the shard of origin
    ``source_table[d, hop]``."""
    from repro_torch.core import topology
    src = torch.as_tensor(topology.source_table(topology.ring("model", n_pe)))
    pe = torch.arange(n_pe)
    q_off = (pe * sq).repeat_interleave(batch)
    k_off = (src[:, hop] * sq).repeat_interleave(batch)
    return q_off, k_off


@pytest.mark.parametrize("n_pe,batch,sq", [(4, 2, 8), (4, 1, 16), (2, 3, 5)])
def test_live_pairs_equal_the_ports_key_mask(n_pe, batch, sq):
    from repro_torch.kernels.flash_attention import kernel as fk
    for hop in range(n_pe):
        q_off, k_off = _ring_offsets(n_pe, batch, sq, hop)
        klen = torch.full_like(q_off, 10**9)
        live = fk.key_mask(q_off, k_off, klen, sq, sq, causal=True,
                           window=0).sum()
        assert flash_carry.live_pairs(n_pe, batch, sq, hop) == int(live)


def test_flash_work_equals_the_ports():
    """At a ring hop of the port's zamba2-1.2b (no cell runs one yet)."""
    from dataclasses import asdict

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    model = asdict(get_config("zamba2-1.2b"))
    s = flash_carry.hop_shape(model, 4, 2048, 4)
    m = lambda *shape, dt=BF16: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    q = m(s["rows"], s["sq"], s["h"], s["d"])
    k = m(s["rows"], s["sq"], s["kvh"], s["d"])
    st = (m(s["rows"], s["h"], s["sq"], dt=F32),
          m(s["rows"], s["h"], s["sq"], dt=F32),
          m(s["rows"], s["h"], s["sq"], s["d"], dt=F32))
    for hop in range(4):
        pairs = flash_carry.live_pairs(4, 4, s["sq"], hop)
        assert flash_carry.work(**s, pairs=pairs) == \
            fk.work(q, k, *st, pairs=pairs)[:2]
        assert flash_carry_bwd.work(**s, pairs=pairs) == \
            fk.backward_work(q, k, st[0], st[2], pairs=pairs)[:2]


def test_peaks_equal_the_ports():
    from repro_torch.roofline import hw
    assert peaks.PEAK_FLOPS == hw.PEAK_FLOPS
    assert peaks.HBM_BW == hw.HBM_BW


@pytest.mark.parametrize("cell_name", list(CELL_SHAPES))
def test_model_weights_count_the_ports_tree(cell_name):
    """``flops.body_weights``: every weight of two or more dimensions
    below the embedding."""
    from repro_torch.train.step import params_shapes
    from perfbench.lib.tree import leaves
    cell = bench.load_cell(cell_name)
    model = cell.model_config()
    total = 0
    for path, t in leaves(params_shapes(model, device="cpu")):
        if t.dim() < 2 or path[0] == "embed":
            continue
        total += t.numel()
    assert flops.body_weights(cell.config) == total


def test_per_call_flops_at_the_cells():
    t = bench.load_cell("mamba2-1.3b.train")
    p = bench.load_cell("mamba2-1.3b.prefill")
    body = flops.body_weights(t.config)
    assert flops.per_call(t.config, t.traffic) == \
        6.0 * (body + 2048 * 50288) * 8 * 2048
    assert flops.per_call(p.config, p.traffic) == \
        2.0 * (body * 4 * 2048 + 2048 * 50288 * 4)


def _evt(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end), device_type="DeviceType.CUDA" if device
        else "DeviceType.CPU", is_user_annotation=False)


def test_trace_reading_on_a_made_up_timeline():
    events = [
        _evt(trace.CALL, 0, 100), _evt(trace.CALL, 100, 200),
        _evt("aten::mul", 5, 15), _evt("cudaLaunchKernel", 8, 12),
        _evt("aten::mm", 40, 60),
        _evt("k_mul", 10, 30, True), _evt("k_mm", 50, 90, True),
        _evt("k_mm", 85, 95, True), _evt("k_mul", 150, 250, True),
        _evt(trace.CALL, 0, 100, True),            # the range's mirror
    ]
    t = trace.read(events)
    assert t.calls == 2 and t.window_s == pytest.approx(200e-6)
    # busy [10, 30] + [50, 95] + [150, 200] clipped to the window
    assert t.busy_s == pytest.approx(115e-6)
    assert t.kernel_n == {"k_mul": 2, "k_mm": 2}
    assert t.kernel_s["k_mm"] == pytest.approx(50e-6)
    # gaps [0,10] (mid 5: aten::mul), [30,50] (mid 40: aten::mm opens at
    # 40), [95,150] (host Python)
    assert t.gaps_s == pytest.approx({"aten::mul": 10e-6, "aten::mm": 20e-6,
                                      trace.HOST_PYTHON: 55e-6})
    assert t.top(t.gaps_s, 1) == [[trace.HOST_PYTHON, t.gaps_s[trace.HOST_PYTHON]]]


@pytest.mark.parametrize("name,kind", [
    ("void ssd_bwd_kernel_mma<64>(Args)", "hand_written"),
    ("flash_carry_bwd_kernel_rows_mma<64>", "hand_written"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BinaryFunctor<float, float, float, MulFunctor>>", "glue"),
])
def test_kernel_kinds(name, kind):
    assert kernel_names.kind(name) == kind
