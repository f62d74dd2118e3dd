#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and time every kernel
on the card, then serve qwen3-0.6b at full width on the emulated ring.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` into ``build/``). Phases; any failure exits
non-zero before the result lines are printed:

1. device and build: the card's name and power limit, both kernels built
   in parallel;
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the stated tolerances; each timed (device time
   under ``torch.profiler``) beside its twin, its bound and, where one
   PyTorch call computes the same function, that call (used here as a
   yardstick only);
3. serving: ``ServeEngine`` over ``RingShardedBackend(n_pe=4, mode="qlr")``,
   whose ring hops run the kernels, qwen3-0.6b at full width in bf16 with
   random weights from a seed, 8 requests plus 4 admitted mid-run; every kernel's
   launch count must rise during this run; then one prefill and one decode
   step under ``torch.profiler`` for device time by kernel and idle share;
4. modes agree: one prefill and one decode step at full width, 4 layers,
   fp32, ring+kernel backends (qlr, xqueue, sw) against the dense backend.

The last three lines of standard output are the kernels' JSON, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bf16": 989e12,      # dense tensor-core rate
              "fp32": 67e12}       # fp32 outside the tensor cores
N_PE = 4
BATCH = 8
MAX_SEQ = 1024
CHUNK = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_rows(prof):
    """(name, device ms, count) of every device kernel in a profile. CPU
    ops are skipped: their kernels appear as rows of their own."""
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def time_ms(fn, iters: int = 20, only: str | None = None) -> float:
    """Device time of one call: the kernels' durations under
    ``torch.profiler``, summed over ``iters`` calls, divided by ``iters``
    (only the kernels whose name contains ``only``, when given). CUDA
    events around the calls would time the Python wrapper instead wherever
    a kernel is shorter than its launch path."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()                                         # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(ms for name, ms, _ in _kernel_rows(prof)
               if only is None or only in name)
    if busy == 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def flash_cases(torch, fk, dev):
    """Main-path shapes of qwen3-0.6b on a ring of 4 at the serving batch:
    a prefill hop (32 PE x batch rows, 64 queries, 64 keys) and a decode
    hop (8 query rows, 256 resident slots of a [8*4, 256] cache view)."""
    g = torch.Generator(device=dev).manual_seed(0)
    h, kvh, hd = 16, 8, 128
    bf = torch.bfloat16
    rows = N_PE * BATCH
    s_l = CHUNK // N_PE
    pe = torch.arange(N_PE, device=dev).repeat_interleave(BATCH)

    def state(r, sq, fresh):
        m = torch.full((r, h, sq), -1e30, device=dev) if fresh else \
            torch.randn(r, h, sq, generator=g, device=dev)
        l = torch.zeros(r, h, sq, device=dev) if fresh else \
            torch.rand(r, h, sq, generator=g, device=dev) + 1
        acc = torch.zeros(r, h, sq, hd, device=dev) if fresh else \
            torch.randn(r, h, sq, hd, generator=g, device=dev)
        return m, l, acc

    q = torch.randn(rows, s_l, h, hd, generator=g, device=dev).to(bf)
    k = torch.randn(rows, s_l, kvh, hd, generator=g, device=dev).to(bf)
    v = torch.randn(rows, s_l, kvh, hd, generator=g, device=dev).to(bf)
    big = torch.tensor(2 ** 30, device=dev).expand(rows)
    src = (pe - 1) % N_PE                      # hop 1: some blocks masked
    m, l, acc = state(rows, s_l, fresh=False)
    m[::3] = -1e30
    cases = {
        "prefill_hop": dict(
            args=(q, k, v, m, l, acc, pe * s_l, src * s_l, big, None),
            opts=dict(causal=True, window=0, normalize=False)),
        "prefill_hop_noncausal": dict(
            args=(q, k, v, m, l, acc, pe * s_l, src * s_l,
                  src * s_l + 40, None),
            opts=dict(causal=False, window=0, normalize=False)),
        "prefill_normalized": dict(
            args=(q, k, v, *state(rows, s_l, fresh=True),
                  0 * pe, 0 * pe, big, None),
            opts=dict(causal=True, window=0, normalize=True,
                      out_dtype=bf)),
    }
    # decode: the cache [8, 1024, 8, 128] viewed as [8*4, 256, 8, 128];
    # PE d folds its resident slots of the rows that originated at src
    b_loc, s_loc = BATCH // N_PE, MAX_SEQ // N_PE
    kc = torch.randn(BATCH, MAX_SEQ, kvh, hd, generator=g, device=dev).to(bf)
    vc = torch.randn(BATCH, MAX_SEQ, kvh, hd, generator=g, device=dev).to(bf)
    pos = torch.randint(64, 280, (BATCH,), generator=g, device=dev)
    dpe = torch.arange(N_PE, device=dev).repeat_interleave(b_loc)
    dsrc = (dpe - 1) % N_PE
    cache_row = dsrc * b_loc + torch.arange(b_loc, device=dev).repeat(N_PE)
    qd = torch.randn(BATCH, 1, h, hd, generator=g, device=dev)   # fp32 query
    md, ld, accd = state(BATCH, 1, fresh=False)
    md[::2] = -1e30
    cases["decode_hop"] = dict(
        args=(qd, kc.view(BATCH * N_PE, s_loc, kvh, hd),
              vc.view(BATCH * N_PE, s_loc, kvh, hd), md, ld, accd,
              0 * dpe, dpe * s_loc, pos[cache_row] + 1,
              cache_row * N_PE + dpe),
        opts=dict(causal=False, window=0, normalize=False))
    return cases


def flash_bound(torch, fk, args, opts):
    """Bytes and operations this call's data needs: the queries, the K/V
    of keys some query of the row may attend to, the state in and out;
    4*D operations per (query, head, attended key)."""
    q, k, v, m, l, acc, q_off, k_off, klen, kv_row = args
    bp, sq, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    mask = fk.key_mask(q_off.int(), k_off.int(), klen.int(), sq, t,
                       causal=opts["causal"], window=opts["window"])
    keys_needed = int(mask.any(dim=1).sum())
    kv_bytes = keys_needed * kvh * d * 2 * k.element_size()
    out_bytes = m.numel() * 4 * 2 + acc.numel() * (
        2 if opts.get("normalize") else 4)
    total = nbytes(q, m, l, acc) + kv_bytes + out_bytes
    flops = 4 * d * h * int(mask.sum())
    kind = "bf16" if q.dtype == k.dtype == torch.bfloat16 else "fp32"
    return bound(total, flops, kind)


def sdpa_call(torch, q, k, v):
    """One PyTorch call computing the normalized causal attention of the
    same q/k/v (GQA), as a yardstick."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        ke = kt.repeat_interleave(rep, 1)
        ve = vt.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                      is_causal=True)


def check_flash(torch, fk, dev):
    out = []
    for name, case in flash_cases(torch, fk, dev).items():
        args, opts = case["args"], case["opts"]
        got = fk.flash_carry_cuda(*args, **opts)
        want = fk.flash_carry_plain(*args, **opts)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # fp32 state: both sum the same fp32 products in another order;
        # a bf16 output adds one bf16 rounding of values of order 1
        tol = 2e-2 if opts.get("normalize") else 2e-4
        ok = err <= tol * max(1.0, max(float(w.float().abs().max())
                                       for w in want[2:]))
        lib = None
        if opts.get("normalize"):
            call = sdpa_call(torch, args[0], args[1], args[2])
            ok = ok and float((call().float() - got[2].float())
                              .abs().max()) <= 2e-2
            lib = time_ms(call)
        b_ms, b_by = flash_bound(torch, fk, args, opts)
        rec = {"case": name, "max_abs_err": err, "tol": tol, "ok": ok,
               "ms": time_ms(lambda: fk.flash_carry_cuda(*args, **opts),
                             only="flash_carry_kernel"),
               "plain_ms": time_ms(lambda: fk.flash_carry_plain(*args,
                                                                 **opts)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
               "shape": {"q": list(args[0].shape), "k": list(args[1].shape),
                         "dtype_q": str(args[0].dtype),
                         "dtype_kv": str(args[1].dtype)}}
        log(f"[kernels] flash_carry {name}: max_abs_err={err:.3e} "
            f"(tol {tol}) kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"library {lib}")
        out.append(rec)
    return out


def check_matmul(torch, mk, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    d, f, m = 1024, 3072 // N_PE, BATCH * CHUNK // N_PE    # M = 512 per PE

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    cases = {
        # AG ring hop of the FFN (gate or up): x chunk @ w slice
        "ffn_ag_hop": (rnd(N_PE, m, d), rnd(N_PE, d, f), None, bf),
        # AG ring hop of the QKV ring (q sink: 4 of 16 heads per PE)
        "qkv_q_hop": (rnd(N_PE, m, d), rnd(N_PE, d, 512), None, bf),
        # RS ring hop of the FFN with the bf16 travelling accumulator
        "ffn_rs_carry_hop": (rnd(N_PE, m, f), rnd(N_PE, f, d),
                             rnd(N_PE, m, d), bf),
        # the fp32 form (phase 4) with an fp32 carry, ragged M
        "fp32_carry_ragged": (rnd(N_PE, 500, d, dtype=f32),
                              rnd(N_PE, d, 256, dtype=f32),
                              rnd(N_PE, 500, 256, dtype=f32), f32),
    }
    out = []
    for name, (a, b, c, odt) in cases.items():
        got = mk.matmul_cuda(a, b, c, odt)
        want = mk.matmul_plain(a, b, c, odt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        # bf16 out: one bf16 rounding (2^-8 relative) of fp32 sums that
        # differ in order; fp32 out: fp32 sums of K terms in another order
        tol = (2 ** -7 if odt == bf else 1e-5) * max(1.0, scale)
        if c is None:
            lib_call = lambda a=a, b=b: torch.bmm(a, b)        # noqa: E731
        else:
            lib_call = lambda a=a, b=b, c=c: torch.baddbmm(c, a, b)  # noqa
        flops = 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        kind = "bf16" if a.dtype == bf else "fp32"
        b_ms, b_by = bound(nbytes(a, b, c, got), flops, kind)
        rec = {"case": name, "max_abs_err": err, "tol": tol,
               "ok": err <= tol,
               "ms": time_ms(lambda: mk.matmul_cuda(a, b, c, odt),
                             only="tile_matmul_kernel"),
               "plain_ms": time_ms(lambda: mk.matmul_plain(a, b, c, odt)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(lib_call),
               "shape": {"a": list(a.shape), "b": list(b.shape),
                         "carry": c is not None, "dtype": str(a.dtype)}}
        log(f"[kernels] tile_matmul {name}: max_abs_err={err:.3e} (tol "
            f"{tol:.3e}) kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"bmm {rec['library_ms']:.4f} ms")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 3 and 4: the main path
# ---------------------------------------------------------------------------


def serve_full_width(torch, kernels, dev):
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded_cache import RingShardedBackend

    cfg = get_config("qwen3-0.6b")
    params = build_model(cfg).init(seed=0, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK)
    backend = RingShardedBackend(cfg, scfg, params, N_PE, "qlr", device=dev)
    engine = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, cfg.vocab_size,
                            int(rng.integers(64, 257))).astype(np.int32)

    requests = [engine.sched.submit(prompt(), 16) for _ in range(BATCH)]
    late = [prompt() for _ in range(4)]

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while engine.sched.busy or late:
        if tick == 4 and late:                   # admitted mid-run
            requests += [engine.sched.submit(p, 8) for p in late]
            late = []
        engine._admit()
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    tokens = int(engine.metrics.counter("repro_tokens_total").value)
    prefill_tokens = int(engine.metrics.counter(
        "repro_prefill_tokens_total").value)

    assert len(requests) == 12
    for r in requests:
        assert r.status == "done", (r.rid, r.status)
        assert len(r.out_tokens) == r.max_new_tokens, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"

    # per-call launch counts, after the main path's counts were read
    per_call = {}
    slot = 0
    before = {k.name: k.launches for k in kernels}
    backend.prefill(slot, prompt()[:CHUNK])
    torch.cuda.synchronize()
    per_call["prefill"] = {k.name: k.launches - before[k.name]
                           for k in kernels}
    before = {k.name: k.launches for k in kernels}
    logits = backend.step(np.zeros((BATCH, 1), np.int32),
                          np.ones(BATCH, bool))
    torch.cuda.synchronize()
    per_call["decode_step"] = {k.name: k.launches - before[k.name]
                               for k in kernels}
    assert logits.shape == (BATCH, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    breakdown = {
        "prefill": profile(torch, lambda: backend.prefill(
            slot, prompt()[:CHUNK])),
        "decode_step": profile(torch, lambda: backend.step(
            np.zeros((BATCH, 1), np.int32), np.ones(BATCH, bool))),
    }
    result = {"requests": len(requests), "ticks": tick, "tokens": tokens,
              "prefill_tokens": prefill_tokens, "seconds": elapsed,
              "tokens_per_s": tokens / elapsed,
              "launches": launches, "launches_per_call": per_call,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "breakdown": breakdown}
    log(f"[serve] {json.dumps(result)}")
    return result


def profile(torch, fn, top: int = 6) -> dict:
    """Device time by kernel for one call under ``torch.profiler``, and the
    device's idle share of the call's wall time (one stream, so kernel
    times add up to the busy time)."""
    from torch.profiler import ProfilerActivity
    fn()                                         # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device": "not measured"}
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [{"kernel": k[:80], "ms": ms, "count": n}
                   for k, ms, n in rows[:top]]}
    log(f"[profile] {json.dumps(out)}")
    return out


def modes_agree(torch, dev):
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend

    cfg = replace(get_config("qwen3-0.6b"), num_layers=4, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK)
    rng = np.random.default_rng(1)
    chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, CHUNK)
                            .astype(np.int32), device=dev)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    active = np.ones(BATCH, bool)

    def run(backend):
        with torch.inference_mode():
            logit, _ = backend.model.prefill_into_cache(
                backend.params, backend.cache, chunk, 3, 200)
        return logit.clone(), backend.step(toks, active).clone()

    dense = run(DecodeBackend(cfg, scfg, params, device=dev))
    tol = 2e-3          # tests/test_parity.py's fp32 bound
    errs = {}
    for mode in ("qlr", "xqueue", "sw"):
        got = run(RingShardedBackend(cfg, scfg, params, N_PE, mode,
                                     device=dev))
        errs[mode] = [float((g - w).abs().max() /
                            max(1.0, float(w.abs().max())))
                      for g, w in zip(got, dense)]
        log(f"[modes] {mode}: prefill logits rel err {errs[mode][0]:.3e}, "
            f"decode logits rel err {errs[mode][1]:.3e} (tol {tol})")
        assert max(errs[mode]) <= tol, (mode, errs[mode])
        assert all(bool(torch.isfinite(x).all()) for x in got)
    return errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.systolic_matmul import kernel as mk

    dev = torch.device("cuda")
    card = gpu_name_and_limit()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build_all(kernels.ALL)
    log(f"[build] {len(kernels.ALL)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in kernels.ALL:
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {k.name}: {line.strip()}")

    flash = check_flash(torch, fk, dev)
    mm = check_matmul(torch, mk, dev)
    bad = [r["case"] for r in flash + mm if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")

    served = serve_full_width(torch, kernels.ALL, dev)
    modes_agree(torch, dev)

    def entry(kern, source, replaces, recs, primary):
        top = next(r for r in recs if r["case"] == primary)
        return {"name": kern.name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": served["launches"][kern.name],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "primary_case": primary,
                "launches_per_call": {c: v[kern.name] for c, v in
                                      served["launches_per_call"].items()},
                "cases": recs}

    report = {"kernels": [
        entry(fk.FLASH_CARRY, "src/repro_torch/csrc/flash_carry.cu",
              "src/repro/kernels/flash_attention/kernel.py:140", flash,
              "decode_hop"),
        entry(mk.TILE_MATMUL, "src/repro_torch/csrc/tile_matmul.cu",
              "src/repro/kernels/systolic_matmul/kernel.py:104", mm,
              "ffn_ag_hop"),
    ], "serve": served}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
