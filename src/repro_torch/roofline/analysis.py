"""Roofline analysis of the dry run's records, on one H100.

Per cell (arch x shape on one card):
  compute term = sum over types of FLOPs / the card's peak for that type
                 (bf16 989 TFLOP/s on the tensor cores; fp32 67 TFLOP/s
                 outside them: the port is timed with TF32 off)
  memory term  = op-boundary bytes / 3.35 TB/s (the ring hops' copies
                 included)
  link term    = the hops' payload and multicast bytes / 3.35 TB/s: their
                 share of the memory term, reported and not added (the
                 ring is emulated in one card's memory, so a hop is a
                 copy, not a link)
The bound is the larger of compute and memory (``dominant``).

MODEL_FLOPS, as in the reference: train = 6*N*D, prefill = 2*N*D, decode =
2*N_active*B (D = tokens processed; MoE counts active params; the counts
include the embeddings and no attention). ``useful_ratio`` = MODEL_FLOPS /
counted FLOPs exposes remat's recompute and the attention the formula
leaves out; ``mfu`` of a measured step is MODEL_FLOPS / (step time x the
bf16 peak).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.analysis \\
      [--dir build/dryrun] [--out build/roofline.json]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.kernels._build import BUILD
from repro_torch.roofline import hw

ARTIFACTS = BUILD / "dryrun"


def model_flops(meta: dict) -> float:
    n = meta["n_active_params"]
    kind = meta["kind"]
    if kind == "train":
        d = meta["global_batch"] * meta["seq_len"]
        return 6.0 * n * d
    if kind == "prefill":
        d = meta["global_batch"] * meta["seq_len"]
        return 2.0 * n * d
    # decode: one token per row
    return 2.0 * n * meta["global_batch"]


def mfu(meta: dict, step_s: float) -> float:
    """Model FLOPs over a measured step at the card's bf16 peak."""
    return model_flops(meta) / (step_s * hw.PEAK_FLOPS["bf16"])


def analyze_cell(record) -> dict | None:
    """The roofline terms of one dry-run record (a dict or the path of
    its JSON file); None for a record that is not ``ok``."""
    rec = record if isinstance(record, dict) else \
        json.loads(Path(record).read_text())
    if not rec.get("ok"):
        return None
    counts = rec["counts"]
    f_dev = counts["flops_per_device"]
    compute_t = sum(f / hw.PEAK_FLOPS[kind]
                    for kind, f in counts["flops_by_kind"].items())
    memory_t = counts["hbm_bytes_per_device"] / hw.HBM_BW
    link_t = counts["link_bytes"] / hw.HBM_BW
    terms = {"compute": compute_t, "memory": memory_t}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec)
    return {
        "cell": rec["cell"], "arch": rec["arch"], "shape": rec["shape"],
        "kind": rec["kind"], "chips": rec["chips"], "device": rec["device"],
        "flops_per_device": f_dev,
        "flops_by_kind": counts["flops_by_kind"],
        "hbm_bytes_per_device": counts["hbm_bytes_per_device"],
        "link_bytes": counts["link_bytes"],
        "compute_s": compute_t, "memory_s": memory_t, "link_s": link_t,
        "dominant": dominant,
        "step_s_bound": bound,
        "roofline_fraction": compute_t / bound if bound else 0.0,
        "model_flops": mf,
        "useful_ratio": mf / f_dev if f_dev else 0.0,
        "memory": rec["memory"],
        "by_kernel": counts["by_kernel"],
    }


HINTS = {
    "compute": "compute-bound: gains come from the tensor cores (bf16 "
               "operands where fp32 runs on the CUDA cores, wgmma/mma "
               "tiles, fewer products recomputed under remat)",
    "memory": "HBM-bound: raise arithmetic intensity (fuse the elementwise "
              "glue between kernels, larger microbatches, a smaller cache "
              "type)",
    "link": "the ring's hop copies are most of the bytes: hops that index "
            "the source in place of copying whole buffers",
}


def run(dir_path: Path) -> list[dict]:
    rows = []
    for p in sorted(Path(dir_path).glob("*.json")):
        try:
            row = analyze_cell(p)
        except (KeyError, TypeError, ValueError) as e:
            print(f"[{p.stem}] analysis failed: {type(e).__name__}: {e}")
            continue
        if row:
            rows.append(row)
    return rows


def to_markdown(rows: list[dict]) -> str:
    lines = [
        "| cell | chips | compute (s) | memory (s) | link (s) | "
        "dominant | roofline frac | useful FLOP ratio |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['cell']} | {r['chips']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['link_s']:.3e} | "
            f"{r['dominant']} | {r['roofline_fraction']:.2f} | "
            f"{r['useful_ratio']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ARTIFACTS))
    ap.add_argument("--out", default=str(BUILD / "roofline.json"))
    args = ap.parse_args(argv)
    rows = run(Path(args.dir))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=2))
    print(to_markdown(rows))
    print(f"\n{len(rows)} cells analyzed -> {args.out}")
    for r in rows:
        hint = HINTS[r["dominant"]]
        if r["dominant"] == "memory" and r["link_s"] > r["memory_s"] / 2:
            hint = HINTS["link"]
        print(f"{r['cell']}: {r['dominant']} bound -> {hint}")


if __name__ == "__main__":
    main()
