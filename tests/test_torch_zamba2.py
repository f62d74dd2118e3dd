"""The published Zamba2 layer (``zamba2-7b``, the port's ``Zamba2LM``) on
the CPU, fp32, seeded:

* the port against the plain reference (``perfbench/reference/zamba2.py``)
  at SMOKE widths and the cell's 18 layers (hybrid at 6, 11 and 17:
  block 0 called twice): last-position logits and
  the loss and every leaf's gradient, without a ring and over the qlr ring
  of 4 (the QKV ring and ring attention through the kernels' twins);
* the reference against ``transformers``' ``Zamba2ForCausalLM`` (eager
  attention, no cache) with the same weights mapped by name, where
  ``transformers`` is installed: the concatenated input, the 1/sqrt(hd/2)
  scale, the blocks taken in turn, the per-call adapters and where tau
  enters;
* the flash twins with an explicit softmax scale at head_dim 224, forward
  and backward, against plain attention;
* the gated RMSNorm at one group and eps 1e-6 bit for bit with its
  whole-width formula, and grouped;
* the spans of a remat step: ``zamba2.shared`` once a call, again under
  the recompute, with ``zamba2.attn`` and ``zamba2.mlp`` inside.

The weights are the benchmark's (``perfbench/lib/weights.py``: no leaf at
0 or 1). No JAX.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.models import build_model, ssm
from repro_torch.obs import trace
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import tree, weights  # noqa: E402
from perfbench.reference import zamba2 as ref  # noqa: E402

SEQ = 32
HYBRID = (6, 11, 17)


def _cfg(**kw):
    return dataclasses.replace(get_smoke_config("zamba2-7b"),
                               dtype="float32", param_dtype="float32", **kw)


def _ref_cfg(cfg):
    return dataclasses.asdict(cfg)


def _batch(cfg, seed=1):
    tok = torch.randint(0, cfg.vocab_size, (2, SEQ + 1),
                        generator=torch.Generator().manual_seed(seed))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


@pytest.fixture(scope="module")
def params():
    return weights.make(_cfg(), 7, "cpu")


def test_smoke_keeps_the_published_pattern():
    cfg = get_smoke_config("zamba2-7b")
    model = build_model(cfg)
    assert model.hybrid == list(HYBRID) and cfg.num_mem_blocks == 2
    assert cfg.num_layers == get_config("zamba2-7b").num_layers == 18
    p = model.init(seed=0, device="cpu")
    assert len(p["layers"]) == 18 and len(p["shared"]) == 2
    assert len(p["adapters"]) == len(p["linears"]) == 3
    assert p["shared"][0]["attn"]["wq"].shape == (2 * cfg.d_model, 4, 32)
    assert p["shared"][0]["norm1"]["scale"].shape == (2 * cfg.d_model,)
    with pytest.raises(NotImplementedError):
        model.init_cache(1, 8, device="cpu")


@pytest.mark.parametrize("n_pe", [0, 4])
def test_port_against_reference(params, n_pe):
    """Logits within 1e-4 of max(1, the largest); the loss within 1e-5
    relative and each leaf's gradient within 1e-4 of max(its largest,
    1e-3 of the median leaf's): fp32 both, the sums in other orders (SSD
    by chunks against the minimal listing, the ring's hops)."""
    cfg = _cfg(systolic_mode="qlr" if n_pe else "baseline")
    model = build_model(cfg, n_pe=n_pe)
    batch = _batch(cfg)
    rcfg = _ref_cfg(cfg)
    with torch.no_grad():
        got = model.prefill(params, batch["tokens"])
        want = ref.last_logits(params, batch["tokens"], rcfg)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * max(1.0, float(want.abs().max())))

    paths = [p for p, _ in tree.leaves(params)]
    leaves = [t.clone().requires_grad_(True) for _, t in tree.leaves(params)]
    p_tree = tree.rebuild(params, dict(zip(paths, leaves)))
    loss, _ = model.loss(p_tree, batch)
    got_g = torch.autograd.grad(loss, leaves)
    r_leaves = [t.clone().requires_grad_(True) for _, t in tree.leaves(params)]
    r_tree = tree.rebuild(params, dict(zip(paths, r_leaves)))
    r_loss = ref.loss(r_tree, batch["tokens"], batch["targets"], rcfg)
    want_g = torch.autograd.grad(r_loss, r_leaves)
    loss, r_loss = float(loss.detach()), float(r_loss.detach())
    assert abs(loss - r_loss) <= 1e-5 * abs(r_loss)
    scales = [float(g.abs().max()) for g in want_g]
    floor = 1e-3 * sorted(scales)[len(scales) // 2]
    for path, g, w, s in zip(paths, got_g, want_g, scales):
        assert s > 0, path
        torch.testing.assert_close(
            g, w, rtol=0, atol=1e-4 * max(s, floor),
            msg=lambda m, path=path: f"{'.'.join(path)}: {m}")


def _hf_model(cfg):
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    transformers = pytest.importorskip("transformers")
    blocks = ["hybrid" if i in HYBRID else "mamba"
              for i in range(cfg.num_layers)]
    hf_cfg = transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.num_layers, layers_block_type=blocks,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_heads,
        n_mamba_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
        mamba_d_state=cfg.ssm_state, mamba_ngroups=cfg.ssm_ngroups,
        mamba_d_conv=cfg.ssm_conv_kernel, mamba_expand=cfg.ssm_expand,
        chunk_size=SEQ, intermediate_size=cfg.d_ff,
        hidden_act="gelu", num_mem_blocks=2, use_mem_rope=True,
        use_shared_attention_adapter=False, adapter_rank=cfg.adapter_rank,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        use_cache=False, tie_word_embeddings=True,
        attn_implementation="eager")
    assert hf_cfg.hybrid_layer_ids == list(HYBRID)
    assert hf_cfg.attention_head_dim == cfg.head_dim
    hf = transformers.Zamba2ForCausalLM(hf_cfg).eval()
    # no dt floor: the release's fused path takes none (its
    # time_step_limit is null); the eager path clamps dt at time_step_min.
    # The eager path's chunked scan also sums its inter-chunk recurrence
    # over the target chunk (``.sum(dim=2)``) where the fused path sums
    # over the source, so it gets one chunk of the whole sequence above;
    # the reference keeps its chunks of ssm_chunk.
    for mod in hf.modules():
        if hasattr(mod, "time_step_min"):
            mod.time_step_min = 0.0
    return hf


def _load_hf(hf, p):
    """Copy the reference tree ``p`` into the ``transformers`` model by
    name (its Linear weights are [out, in])."""
    m = hf.model

    def put(dst, src):
        assert dst.shape == src.shape, (dst.shape, src.shape)
        dst.copy_(src)

    def mamba(dst, lp):
        mx = lp["mixer"]
        put(dst.input_layernorm.weight, lp["norm"]["scale"])
        put(dst.mamba.in_proj.weight, mx["w_in"].t())
        put(dst.mamba.conv1d.weight, mx["conv_w"].t()[:, None, :])
        put(dst.mamba.conv1d.bias, mx["conv_b"])
        for name in ("A_log", "D", "dt_bias"):
            put(getattr(dst.mamba, name), mx[name])
        put(dst.mamba.norm.weight, mx["norm_scale"])
        put(dst.mamba.out_proj.weight, mx["w_out"].t())

    with torch.no_grad():
        put(m.embed_tokens.weight, p["embed"]["table"])
        put(m.final_layernorm.weight, p["final_norm"]["scale"])
        c = 0
        for i, layer in enumerate(m.layers):
            if i not in HYBRID:
                mamba(layer, p["layers"][i])
                continue
            mamba(layer.mamba_decoder, p["layers"][i])
            put(layer.linear.weight, p["linears"][c]["w"].t())
            blk, sp = layer.shared_transformer, p["shared"][c % 2]
            assert blk.block_id == c % 2
            put(blk.input_layernorm.weight, sp["norm1"]["scale"])
            put(blk.pre_ff_layernorm.weight, sp["norm2"]["scale"])
            at = blk.self_attn
            for name in ("q", "k", "v"):
                w = sp["attn"][f"w{name}"]
                put(getattr(at, f"{name}_proj").weight,
                    w.reshape(w.shape[0], -1).t())
            wo = sp["attn"]["wo"]
            put(at.o_proj.weight, wo.reshape(-1, wo.shape[-1]).t())
            ff = blk.feed_forward
            put(ff.gate_up_proj.weight, sp["mlp"]["w_gate_up"].t())
            put(ff.down_proj.weight, sp["mlp"]["w_down"].t())
            ad = ff.gate_up_proj_adapter_list[c]
            put(ad[0].weight, p["adapters"][c]["a"].t())
            put(ad[1].weight, p["adapters"][c]["b"].t())
            c += 1


def test_reference_against_transformers(params):
    """The reference's logits at every position and its loss within 1e-4
    of max(1, the largest) of ``Zamba2ForCausalLM``'s, fp32 both (the
    naive chunked SSD and eager attention against the minimal listing)."""
    cfg = _cfg()
    hf = _hf_model(cfg)
    _load_hf(hf, params)
    batch = _batch(cfg, seed=3)
    with torch.no_grad():
        out = hf(input_ids=batch["tokens"], use_cache=False)
        want = out.logits.float()
        rcfg = _ref_cfg(cfg)
        got = ref.head(params, ref.hidden(params, batch["tokens"], rcfg,
                                          "fp32"), "fp32")
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * max(1.0, float(want.abs().max())))
    ce = F.cross_entropy(want.reshape(-1, want.shape[-1]),
                         batch["targets"].reshape(-1))
    with torch.no_grad():
        mine = ref.loss(params, batch["tokens"], batch["targets"], rcfg)
    assert abs(float(mine) - float(ce)) <= 1e-5 * float(ce)


def _plain(q, k, v, scale):
    """Causal softmax attention, fp32: q, k, v [B, S, H, D]."""
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhst,bthd->bhsd", p, v)


@pytest.mark.parametrize("scale", [None, 112 ** -0.5])
def test_flash_twins_take_a_scale_at_head_dim_224(scale):
    """``flash_carry_plain`` from zero state, normalized, against plain
    attention (1e-5); ``flash_carry_backward_plain`` against autograd of
    the forward twin (1e-5 of max(1, the largest)); the None scale is
    1/sqrt(224) bit for bit."""
    g = torch.Generator().manual_seed(4)
    b, s, h, d = 2, 16, 2, 224
    q, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    m, l, acc = (torch.full((b, h, s), fk.NEG_INF), torch.zeros(b, h, s),
                 torch.zeros(b, h, s, d))
    zero = torch.zeros(b, dtype=torch.int32)
    klen = torch.full((b,), s, dtype=torch.int32)
    want_scale = 1.0 / math.sqrt(d) if scale is None else scale
    _, _, out = fk.flash_carry_plain(q, k, v, m, l, acc, zero, zero, klen,
                                     causal=True, normalize=True,
                                     scale=scale)
    torch.testing.assert_close(out, _plain(q, k, v, want_scale), rtol=0,
                               atol=1e-5)
    if scale is None:
        explicit = fk.flash_carry_plain(q, k, v, m, l, acc, zero, zero, klen,
                                        causal=True, normalize=True,
                                        scale=1.0 / math.sqrt(d))[2]
        assert torch.equal(out, explicit)

    ins = [x.clone().requires_grad_(True) for x in (q, k, v, m, l, acc)]
    outs = fk.flash_carry_plain(*ins, zero, zero, klen, causal=True,
                                scale=scale)
    ups = [torch.randn(x.shape, generator=g) for x in outs]
    want = torch.autograd.grad(outs, ins, ups)
    got = fk.flash_carry_backward_plain(
        q, k, v, m, l, acc, zero, zero, klen, None,
        *(o.detach() for o in outs), *ups, causal=True, scale=scale)
    for x, y in zip(got, want):
        torch.testing.assert_close(
            x, y, rtol=0, atol=1e-5 * max(1.0, float(y.abs().max())))


def _gated_inputs(cfg, seed=5):
    g = torch.Generator().manual_seed(seed)
    d_in = cfg.ssm_expand * cfg.d_model
    return ({"norm_scale": 1.0 + 0.1 * torch.randn(d_in, generator=g),
             "w_out": torch.randn(d_in, cfg.d_model, generator=g)},
            torch.randn(2, 8, d_in, generator=g),
            torch.randn(2, 8, d_in, generator=g))


def test_gated_norm_one_group_is_the_whole_width_formula():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype="float32", param_dtype="float32")
    assert cfg.ssm_ngroups == 1 and cfg.gated_norm_eps == 1e-6
    p, y, z = _gated_inputs(cfg)
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    want = torch.matmul(yf, p["w_out"])
    assert torch.equal(ssm._gated_norm_out(p, y, z, cfg), want)


def test_gated_norm_groups_normalise_apart():
    cfg = _cfg()
    p, y, z = _gated_inputs(cfg)
    yz = (y * F.silu(z)).reshape(2, 8, 2, -1)
    yz = yz * torch.rsqrt(yz.square().mean(-1, keepdim=True) + 1e-5)
    want = (yz.reshape(2, 8, -1) * p["norm_scale"]) @ p["w_out"]
    torch.testing.assert_close(ssm._gated_norm_out(p, y, z, cfg), want,
                               rtol=1e-6, atol=1e-5)


@pytest.fixture
def fresh_recording(monkeypatch):
    monkeypatch.setattr(trace, "_armed", 0)
    monkeypatch.setattr(trace, "_backward", [])
    trace._roots.clear()
    yield
    trace._roots.clear()


def test_remat_step_spans(fresh_recording):
    """One traced SMOKE step (remat full, the qlr ring of 4): a
    ``zamba2.shared`` span a call in the forward and one in the backward's
    recompute, each holding ``zamba2.attn`` then ``zamba2.mlp``; a
    ``mamba2.block`` a layer each way; the shared spans never nest in a
    block's (no nested checkpoints)."""
    cfg = dataclasses.replace(_cfg(), remat="full", systolic_mode="qlr")
    tcfg = TrainConfig()
    state = step.init_state(cfg, tcfg, device="cpu")
    train_step = step.make_train_step(cfg, tcfg, 4)
    batch = _batch(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        train_step(state, batch)
    (root,) = trace.last_roots(8)
    shared = [s for s in root.spans if s.name == "zamba2.shared"]
    blocks = [s for s in root.spans if s.name == "mamba2.block"]
    assert Counter(s.recompute for s in shared) == {False: 3, True: 3}
    assert Counter(s.recompute for s in blocks) == {False: 18, True: 18}
    for s in shared:
        assert s.parent.name in ("train.forward", trace.BACKWARD)
        kids = [c.name for c in root.spans if c.parent is s]
        assert kids == ["zamba2.attn", "zamba2.mlp"]
