"""The readings each correctness limit is set from, on the card at a cell's
own sizes (not part of a benchmark run):

* the program's numbers on many seeds (the lower readings), each from a
  whole run with a short window;
* the control's on the first ``--control`` of them: the reference
  computed a precision below the configuration's (fp8 weight products
  for bf16) in the program's place;
* each fault named in ``--faults`` (of the cell's traffic kind's
  ``FAULTS``, ``perfbench/kinds/<kind>.py``), planted in the program, on
  the first ``--fault-seeds`` seeds.

    python3 perfbench/calibrate.py --workload mamba2-1.3b.train \\
        --seeds 11,12,13 --control 3 --faults half_batch --seconds 2 \\
        --out build/cal.jsonl

One JSON line a reading goes to ``--out`` and to standard output.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def raw(kind, side: str) -> dict:
    """A training run's own readings by leaf, and the reference's, so that
    any statistic of them can be worked out afterwards."""
    if not hasattr(kind, "ref") or not isinstance(kind.ref, dict):
        return {}
    flat = lambda r: {k: ({".".join(p): v for p, v in r[k].items()}  # noqa: E731
                          if isinstance(r[k], dict) else r[k])
                      for k in ("loss", "grad", "change")}
    return {"raw": {side: flat(getattr(kind, "program" if side == "program"
                                       else side)),
                    "reference": flat(kind.ref)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import faults
    from perfbench.lib import bench, drive
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a")

    def emit(rec):
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def one(seed, what, fault=None):
        t = time.perf_counter()
        if fault:
            with faults.planted(fault, cell.traffic["kind"]):
                res = drive.run(cell, seed, args.seconds, False, dev, t)
        else:
            res = drive.run(cell, seed, args.seconds, False, dev, t)
        kind = res.pop("_kind")
        emit({"what": what, "seed": seed, "numbers": res["numbers"],
              "e2e": res["e2e"], "peak": res["peak"],
              "seconds": res["seconds"], **raw(kind, "program")})
        if what == "program" and seeds.index(seed) < args.control:
            t = time.perf_counter()
            emit({"what": "control", "seed": seed,
                  "numbers": kind.control(),
                  "seconds": time.perf_counter() - t, **raw(kind, "low")})
        del kind, res
        gc.collect()
        torch.cuda.empty_cache()

    for seed in seeds:
        one(seed, "program")
    for fault in filter(None, args.faults.split(",")):
        for seed in seeds[:args.fault_seeds]:
            one(seed, "fault:" + fault, fault)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
