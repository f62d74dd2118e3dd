"""Serving driver of the port: the batched continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --device cpu

The reference's CLI (``repro/launch/serve.py``) on one card. The same
host-side scheduler drives two backends:

  --backend dense   one decode step per tick, no ring
  --backend ring    the KV cache sharded over an emulated ring of --n-pe PEs
                    (default 4), queries streamed systolically (--mode
                    sw/xqueue/qlr, or baseline for the all-gather form)

``--n-pe`` takes the place of the reference's ``--mesh DxM``: one card has
no device mesh. ``--device`` picks the device (default ``cuda``; it raises
when there is no GPU, and runs on the CPU only when asked to with
``--device cpu``). Without ``--full`` the model is the SMOKE config.
Parameters come from the port's own init, a ``torch.Generator`` seeded
with 0; prompts from ``np.random.default_rng(0)``, as in the reference.

Robustness flags (``serve/health.py``): --checked arms tag/checksum-checked
links plus a per-tick canary probe on the ring backend; --monitor guards
every tick (snapshot/rollback, poisoned-request eviction, mode-ladder
degradation); --deadline SECONDS adds a wall-clock budget per step;
--eos-token retires a slot when it samples that token.

Observability flags: --metrics-out FILE.json writes the metrics snapshot
(a FILE.prom Prometheus twin lands next to it); --trace-out FILE.json
writes a Chrome trace of the engine's tick phases (Perfetto or
chrome://tracing); --telemetry arms link-traffic counters on the ring
backend (queue push/pop, payload bytes, checked-link errors), folded into
the metrics as repro_link_*.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ServeConfig, get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.health import HealthConfig
from repro_torch.serve.sharded_cache import RingShardedBackend


def main(argv=None):
    """Serve ``--requests`` random prompts; returns (engine, requests)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--backend", choices=("dense", "ring"), default="dense")
    ap.add_argument("--mode", default="qlr",
                    choices=("baseline", "sw", "xqueue", "qlr"),
                    help="ring link mode (ignored for --backend dense)")
    ap.add_argument("--n-pe", type=int, default=4,
                    help="PEs of the emulated ring for --backend ring")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="block-prefill up to this many prompt tokens")
    ap.add_argument("--eos-token", type=int, default=-1,
                    help="retire a slot when it samples this id (< 0 = off)")
    ap.add_argument("--checked", action="store_true",
                    help="checked queue links + per-tick probe (ring only)")
    ap.add_argument("--monitor", action="store_true",
                    help="guard every tick with the health monitor")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-step wall-clock budget in seconds (0 = off)")
    ap.add_argument("--metrics-out", default="",
                    help="write metrics snapshot JSON here (+ .prom twin)")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON here (Perfetto)")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm link-traffic telemetry (ring only)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    scfg = ServeConfig(max_batch=args.max_batch, max_seq_len=args.max_seq,
                       temperature=args.temperature,
                       prefill_chunk=args.prefill_chunk,
                       eos_token=args.eos_token)
    params = build_model(cfg).init(seed=0, device=dev)
    backend = None
    if args.backend == "ring":
        backend = RingShardedBackend(cfg, scfg, params, args.n_pe,
                                     mode=args.mode, checked=args.checked,
                                     telemetry=args.telemetry, device=dev)
    health = None
    if args.monitor or args.deadline > 0:
        health = HealthConfig(deadline_s=args.deadline)
    tracer = Tracer() if args.trace_out else None
    engine = ServeEngine(cfg, scfg, params, backend=backend, health=health,
                         tracer=tracer, device=dev)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(2, 12)).astype(np.int32)
        engine.submit(prompt, max_new_tokens=args.max_new)
    reqs = list(engine.pending)

    t0 = time.perf_counter()
    ticks = engine.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests ({engine.backend.name}), "
          f"{total_new} tokens, {ticks} engine ticks, "
          f"{total_new / dt:.1f} tok/s")
    for r in reqs[:4]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} "
              f"status={r.status} finish={r.finish_reason or '-'} "
              f"out={r.out_tokens}")
    if engine.monitor is not None and engine.monitor.events:
        print("health events:")
        for ev in engine.monitor.events:
            print(f"  tick={ev.tick} [{ev.kind}] mode={ev.mode}: {ev.detail}")

    if args.metrics_out or args.trace_out:
        prom = (args.metrics_out.rsplit(".", 1)[0] + ".prom"
                if args.metrics_out else None)
        engine.export_observability(
            metrics_json=args.metrics_out or None, metrics_prom=prom,
            trace_out=args.trace_out or None)
        for p in filter(None, (args.metrics_out, prom, args.trace_out)):
            print(f"wrote {p}")
    return engine, reqs


if __name__ == "__main__":
    main()
