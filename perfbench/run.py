"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout (``src/`` beside ``perfbench/``), on a
machine with as many CUDA cards as the cell asks for; without them it
exits with code 2 and prints no result. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number compared with its limit (also the last lines
of standard error). The port's kernels build into ``build/`` of the
checkout on the first run there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(ctx: dict) -> dict:
    from perfbench.lib import bench
    out = {}
    for m in ctx["cell"].per_layer:
        value = bench.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, res: dict, trace: bool, device: dict) -> dict:
    if trace:
        t = res["_ctx"]["trace"]
        metrics = per_layer(res["_ctx"])
        device = {**device, "busy_s": t.busy_s, "window_s": t.window_s}
        extra = {"breakdown": {"device_ops": t.top(t.kernel_s),
                               "idle_gaps": t.top(t.gaps_s)}}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
        extra = {}
    return {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device,
            **extra, "checks": res["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from perfbench.lib import bench
    cell = bench.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from perfbench.lib import drive
    dev = torch.device("cuda", 0)
    res = drive.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                    T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes": res["peak"]}
    line = result_line(cell, res, bool(args.trace), device)
    print("numbers " + json.dumps(res["numbers"]), file=sys.stderr)
    print("seconds " + json.dumps(res["seconds"]), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
