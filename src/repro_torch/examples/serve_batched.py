"""Batched serving example: continuous batching over one decode step.

Requests with different prompt lengths and generation budgets stream
through a fixed slot batch; per-row cache positions and the active-row
mask keep each request's KV state independent. The host-side scheduler
(``repro_torch/serve/scheduler.py``) is backend-agnostic: pass ``--ring``
to serve from a KV cache ring-sharded over ``--n-pe`` emulated PEs, with
each row's query streamed systolically around the resident shards
(``repro_torch/serve/sharded_cache.py``):

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --ring --mode qlr [--device cpu]

The SMOKE config of ``--arch`` with random weights from seed 0, as in the
JAX package's ``examples/serve_batched.py``; ``run`` takes any config.
``--n-pe`` (default 4, as the serving launcher's) stands for the
reference's "all visible devices". Prompts and budgets come from
``np.random.default_rng(0)`` exactly as there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sharded_cache import RingShardedBackend

MAX_SEQ = 128


def requests(vocab: int, n: int):
    """[(prompt, max_new_tokens)] of ``n`` requests: prompts of 2-19
    tokens and budgets of 4-11, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(2, 20)))
        out.append((prompt.astype(np.int32), int(rng.integers(4, 12))))
    return out


def run(cfg, n_requests: int = 10, max_batch: int = 4,
        temperature: float = 0.0, ring: bool = False, mode: str = "qlr",
        prefill_chunk: int = 0, n_pe: int = 4, params=None,
        device="cuda") -> dict:
    """Serve ``n_requests`` requests of :func:`requests` to completion.
    ``params`` default to ``init(seed=0)``."""
    dev = resolve_device(device)
    if params is None:
        params = build_model(cfg).init(seed=0, device=dev)
    scfg = ServeConfig(max_batch=max_batch, max_seq_len=MAX_SEQ,
                       temperature=temperature, prefill_chunk=prefill_chunk)
    backend = RingShardedBackend(cfg, scfg, params, n_pe, mode=mode,
                                 device=dev) if ring else None
    engine = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
    for prompt, max_new in requests(cfg.vocab_size, n_requests):
        engine.submit(prompt, max_new_tokens=max_new)
    reqs = list(engine.pending)

    t0 = time.perf_counter()
    ticks = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    return {"done": sum(r.done for r in reqs), "requests": len(reqs),
            "backend": engine.backend.name, "tokens": toks, "ticks": ticks,
            "seconds": dt, "tok_per_s": toks / dt, "max_batch": max_batch,
            "out": [{"rid": r.rid, "prompt": len(r.prompt),
                     "tokens": list(r.out_tokens)} for r in reqs]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ring", action="store_true",
                    help="ring-sharded KV backend over --n-pe emulated PEs")
    ap.add_argument("--mode", default="qlr",
                    choices=("baseline", "sw", "xqueue", "qlr"))
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--n-pe", type=int, default=4,
                    help="PEs of the emulated ring behind --ring")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    args = ap.parse_args(argv)

    out = run(get_smoke_config(args.arch), n_requests=args.requests,
              max_batch=args.max_batch, temperature=args.temperature,
              ring=args.ring, mode=args.mode,
              prefill_chunk=args.prefill_chunk, n_pe=args.n_pe,
              device=args.device)
    print(f"{out['done']}/{out['requests']} requests ({out['backend']}), "
          f"{out['tokens']} tokens in {out['ticks']} ticks "
          f"({out['tok_per_s']:.1f} tok/s, slot batch {out['max_batch']})")
    for r in out["out"][:5]:
        print(f"  rid={r['rid']:2d} prompt={r['prompt']:2d} -> "
              f"{r['tokens']}")
    return out


if __name__ == "__main__":
    main()
