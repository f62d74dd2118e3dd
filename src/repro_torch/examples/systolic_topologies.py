"""Systolic-topology playground: the paper's reconfigurable queue networks
on an emulated ring of 8 PEs.

Demonstrates:

* ring / chains / snake topologies as queue graphs;
* the link modes (baseline / sw / xqueue / qlr) on a ring all-gather
  matmul, ring attention and the expert-ring MoE, with op counts showing
  the software-queue bookkeeping overhead that the paper's Xqueue/QLR
  extensions eliminate;
* the hybrid conv2d (halo pops + local loads);
* a 4-stage pipelined FFT stream.

    PYTHONPATH=src python -m repro_torch.examples.systolic_topologies \\
        [--device cpu]

The shapes are those of the JAX package's ``examples/systolic_topologies.py``.
Its ``hlo_ops`` column counts the instructions of a compiled HLO module;
the port runs eagerly and has none, so each mode's call runs once more
under ``roofline.count.Counter``, which counts the aten ops that move
bytes or do arithmetic (``ops``) and the hand-written kernels' launches
(``launches``) of that one call. The conv2d and the FFT run in every mode
(the reference runs them in qlr alone), and every mode must give the same
values there.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np

import torch

from repro_torch.configs.mixtral_8x22b import SMOKE as MIXTRAL_SMOKE
from repro_torch.core.collective_matmul import ring_ag_matmul
from repro_torch.core.fft import pipelined_fft
from repro_torch.core.halo import conv2d_ref, conv2d_systolic
from repro_torch.core.ring_attention import systolic_ring_attention
from repro_torch.core.topology import chains, ring, snake_ring
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import resolve_device
from repro_torch.roofline import count

MODES = ("baseline", "sw", "xqueue", "qlr")
N_PE = 8
FFT_PE = 4                                   # one PE per radix-4 stage
SW_NOTE = "  <- software-queue bookkeeping overhead"
# the expert-ring MoE's config: Mixtral SMOKE at the full model's 8
# experts, fp32
MOE_CFG = replace(MIXTRAL_SMOKE, num_experts=8, dtype="float32",
                  param_dtype="float32")


def make_inputs(device) -> dict:
    """Every section's inputs from seeded generators, at the reference
    example's shapes: x [16,8], w [8,8]; q, k, v [1,32,2,8]; the MoE's
    parameters and x [2,32,D]; a [64,32] image and a 3x3 kernel; [8,4,256]
    complex64 for the FFT."""
    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def normal(seed, *shape):
        return torch.randn(shape, generator=gen(seed), device=dev)

    g = gen(0)
    q, k, v = (torch.randn((1, 32, 2, 8), generator=g, device=dev)
               for _ in range(3))
    return {"x": normal(0, 16, 8), "w": normal(1, 8, 8),
            "q": q, "k": k, "v": v,
            "moe_params": moe_lib.init_moe(gen(4), MOE_CFG),
            "moe_x": normal(5, 2, 32, MOE_CFG.d_model),
            "img": normal(0, 64, 32), "kern": normal(2, 3, 3),
            "xs": torch.complex(normal(0, 8, 4, 256),
                                normal(3, 8, 4, 256))}


def _on(tree, dev):
    """``tree`` (numpy arrays or tensors, nested in dicts) as tensors on
    ``dev``; fp64 and complex128 narrowed to fp32 and complex64."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.tensor(
        np.asarray(tree))
    t = t.to(torch.complex64) if t.is_complex() else t.to(torch.float32)
    return t.to(dev)


def counted(fn):
    """(aten ops, {kernel: launches}) of one call of ``fn``."""
    with count.Counter() as c:
        fn()
    ops = sum(rec["calls"] for rec in c.by_op.values())
    return ops, {k: rec["launches"] for k, rec in c.by_kernel.items()}


def _modes(fn, want) -> dict:
    """Each mode's output of ``fn(mode)`` against ``want`` (max abs error,
    and relative to max |want|), then its ops and launches counted on a
    second call."""
    out = {}
    scale = float(want.abs().max())
    for mode in MODES:
        y = fn(mode)
        err = float((y - want).abs().max())
        ops, launches = counted(lambda m=mode: fn(m))
        out[mode] = {"err": err, "rel_err": err / scale, "ops": ops,
                     "launches": launches, "value": y}
    return out


def causal_attention(q, k, v):
    """Plain causal softmax attention, fp32: q, k, v [B,S,H,hd]."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)


@torch.no_grad()
def run(device="cuda", inputs=None) -> dict:
    """Every section on the emulated ring; ``inputs`` (numpy arrays or
    tensors under :func:`make_inputs`' keys) default to
    :func:`make_inputs`. Each section's record holds per mode the max
    error against its plain reference, its op count and its launches (and
    the output, under ``value``)."""
    dev = resolve_device(device)
    inp = _on(inputs, dev) if inputs is not None else make_inputs(dev)
    out = {"topologies": [
        {"name": t.name, "links": len(t.perm), "perm": list(t.perm)}
        for t in (ring("pe", N_PE), chains("pe", N_PE, 2),
                  snake_ring("pe", 2, 4))]}

    # ring AG-matmul: A streamed, W resident on every PE
    x, w = inp["x"], inp["w"]
    topo = ring("pe", N_PE)
    x_local = x.reshape(N_PE, -1, x.shape[-1])
    w_all = w.expand(N_PE, *w.shape)
    out["matmul"] = _modes(
        lambda mode: ring_ag_matmul(x_local, [w_all], topo, mode)[0],
        (x @ w).expand(N_PE, *x.shape))

    # ring attention: q shards resident, K/V blocks stream the ring
    q, k, v = inp["q"], inp["k"], inp["v"]
    out["attention"] = _modes(
        lambda mode: systolic_ring_attention(q, k, v, N_PE, mode,
                                             causal=True),
        causal_attention(q, k, v))

    # expert-ring MoE: expert shards resident, routed token blocks stream
    params, xt = inp["moe_params"], inp["moe_x"]
    y_ref, _ = moe_lib.apply_moe(params, xt, MOE_CFG)
    out["moe"] = _modes(
        lambda mode: moe_lib.apply_moe(
            params, xt, replace(MOE_CFG, systolic_mode=mode), N_PE)[0],
        y_ref)

    # hybrid conv2d: halo rows popped from neighbours, interior rows local
    img, kern = inp["img"], inp["kern"]
    out["conv2d"] = _modes(
        lambda mode: conv2d_systolic(img, kern, N_PE, mode),
        conv2d_ref(img, kern))

    # pipelined FFT over a 4-stage group
    xs = inp["xs"]
    ref = torch.as_tensor(np.fft.fft(xs.cpu().numpy(), axis=-1)).to(dev)
    out["fft"] = _modes(lambda mode: pipelined_fft(xs, FFT_PE, mode), ref)
    for name in ("conv2d", "fft"):
        base = out[name]["baseline"]["value"]
        out[name]["identical"] = all(
            torch.equal(rec["value"], base)
            for rec in out[name].values() if isinstance(rec, dict))
    return out


def _mode_lines(rec) -> None:
    for mode in MODES:
        r = rec[mode]
        print(f"  {mode:9s} err={r['err']:.1e} ops={r['ops']:4d} "
              f"launches={sum(r['launches'].values()):3d}"
              f"{SW_NOTE if mode == 'sw' else ''}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    args = ap.parse_args(argv)

    out = run(args.device)
    print(f"topologies over {N_PE} PEs:")
    for t in out["topologies"]:
        print(f"  {t['name']:12s} links={t['links']} "
              f"perm={t['perm'][:6]}{'...' if len(t['perm']) > 6 else ''}")
    print("\nring all-gather matmul (A streamed, W resident):")
    _mode_lines(out["matmul"])
    print("\nring attention (q resident / K/V streamed, online softmax):")
    _mode_lines(out["attention"])
    print("\nexpert-ring MoE (Mixtral 8-expert top-2; experts resident, "
          "tokens streamed):")
    _mode_lines(out["moe"])
    conv = out["conv2d"]
    print(f"\nhybrid conv2d (halo queues + local loads): "
          f"err={conv['qlr']['err']:.1e} (modes identical: "
          f"{conv['identical']})")
    fft = out["fft"]
    print(f"{FFT_PE}-stage pipelined radix-4 FFT: "
          f"rel err={fft['qlr']['rel_err']:.1e} (modes identical: "
          f"{fft['identical']})")
    return out


if __name__ == "__main__":
    main()
