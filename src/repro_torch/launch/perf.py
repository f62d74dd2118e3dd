"""Hill-climbing over the dry run: named variants of four cells,
each dry-run again and analysed, their roofline terms side by side.

    PYTHONPATH=src python -m repro_torch.launch.perf --list
    PYTHONPATH=src python -m repro_torch.launch.perf --cell granite \\
        --variant v3_qlr_ring --device cpu
    PYTHONPATH=src python -m repro_torch.launch.perf --cell mixtral \\
        --all-variants --device cpu
    PYTHONPATH=src python -m repro_torch.launch.perf --report

The variants are the reference's (``repro/launch/perf.py``). Those that
change only how the reference shards over its mesh (``sequence_parallel``,
``parallelism="dp"``) have no counterpart on one card: they are recorded
with ``ok: false`` and the reason, and not run. Records land in
``build/perf/<cell>__<variant>.json``; ``--report`` reads them beside the
baseline records of ``build/dryrun``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.kernels._build import BUILD
from repro_torch.launch.dryrun import ARTIFACTS as BASELINES
from repro_torch.launch.dryrun import cell_name, default_n_pe, run_cell

ARTIFACTS = BUILD / "perf"

# variant = (systolic_mode, cfg_overrides, train_overrides)
VARIANTS = {
    # -- granite-34b train_4k: the paper-representative dense cell ---------
    "granite": {
        "arch": "granite-34b", "shape": "train_4k",
        "v0_noSPfix": ("baseline", {"sequence_parallel": False}, {}),
        "v1_spfix": ("baseline", {}, {}),
        "v2_xqueue_ring": ("xqueue", {}, {}),
        "v3_qlr_ring": ("qlr", {}, {}),
        "v4_qlr_mb4": ("qlr", {}, {"microbatches": 4}),
        "v5_qlr_mb4_sel": ("qlr", {"remat": "selective"},
                           {"microbatches": 4}),
        "v6_qlr_mb8_sel": ("qlr", {"remat": "selective"},
                           {"microbatches": 8}),
        "v7_qlr_attn_sel": ("qlr", {"remat": "selective"},
                            {"microbatches": 4}),
    },
    # -- mixtral-8x22b train_4k --------------------------------------------
    "mixtral": {
        "arch": "mixtral-8x22b", "shape": "train_4k",
        "v1_spfix": ("baseline", {}, {}),
        "v2_subexperts": ("baseline", {"moe_subexperts": 2}, {}),
        "v3_sub_mb4": ("baseline", {"moe_subexperts": 2},
                       {"microbatches": 4}),
        "v4_sub_mb4_cf1": ("baseline",
                           {"moe_subexperts": 2, "capacity_factor": 1.0},
                           {"microbatches": 4}),
        "v5_sub_mb2_cf1": ("baseline",
                           {"moe_subexperts": 2, "capacity_factor": 1.0},
                           {"microbatches": 2}),
    },
    # -- deepseek-v2-lite train_4k -----------------------------------------
    "deepseek": {
        "arch": "deepseek-v2-lite-16b", "shape": "train_4k",
        "v1_spfix": ("baseline", {}, {}),
        "v2_mb4": ("baseline", {}, {"microbatches": 4}),
        "v3_mb4_cf1": ("baseline", {"capacity_factor": 1.0},
                       {"microbatches": 4}),
        "v4_mb2": ("baseline", {"capacity_factor": 1.0},
                   {"microbatches": 2}),
    },
    # -- internvl2-1b train_4k ----------------------------------------------
    "internvl": {
        "arch": "internvl2-1b", "shape": "train_4k",
        "i1_spfix": ("baseline", {}, {}),
        "i2_pure_dp": ("baseline", {"parallelism": "dp"},
                       {"microbatches": 1}),
        "i3_dp_mb4": ("baseline", {"parallelism": "dp"},
                      {"microbatches": 4}),
    },
}


def variants(cell_key: str) -> list[str]:
    return [v for v in VARIANTS[cell_key] if v not in ("arch", "shape")]


def variant_name(cell_key: str, variant: str) -> str:
    spec = VARIANTS[cell_key]
    mode = spec[variant][0]
    n_pe = default_n_pe(get_config(spec["arch"]), mode)
    return cell_name(spec["arch"], spec["shape"], mode, n_pe, variant)


def run_variant(cell_key: str, variant: str, device="cuda",
                out_dir=ARTIFACTS) -> dict:
    spec = VARIANTS[cell_key]
    mode, cfg_over, train_over = spec[variant]
    return run_cell(spec["arch"], spec["shape"], mode, device=device,
                    out_dir=out_dir, extra_overrides=cfg_over or None,
                    tag=variant, train_overrides=train_over or None)


def report(perf_dir=ARTIFACTS, base_dir=BASELINES) -> None:
    from repro_torch.roofline.analysis import analyze_cell
    for cell_key, spec in VARIANTS.items():
        arch, shape = spec["arch"], spec["shape"]
        rows = []
        base = base_dir / f"{cell_name(arch, shape)}.json"
        if base.exists():
            r = analyze_cell(base)
            if r:
                rows.append(("baseline(dryrun)", r))
        for name in variants(cell_key):
            p = perf_dir / f"{variant_name(cell_key, name)}.json"
            if p.exists():
                r = analyze_cell(p)
                if r:
                    rows.append((name, r))
        if not rows:
            continue
        print(f"\n### {cell_key}: {arch} x {shape} (one card)")
        print("| variant | compute s | memory s | link s | bound | "
              "step bound s | useful |")
        print("|---|---|---|---|---|---|---|")
        for name, r in rows:
            print(f"| {name} | {r['compute_s']:.2f} | {r['memory_s']:.2f} | "
                  f"{r['link_s']:.2f} | {r['dominant']} | "
                  f"{r['step_s_bound']:.2f} | {r['useful_ratio']:.2f} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(VARIANTS))
    ap.add_argument("--variant")
    ap.add_argument("--all-variants", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the dry run's fake tensors (default "
                         "cuda; 'cpu' counts the same without a card)")
    args = ap.parse_args(argv)
    if args.list:
        for k, spec in VARIANTS.items():
            print(f"{k}: {spec['arch']} x {spec['shape']}: "
                  f"{', '.join(variants(k))}")
        return
    if args.report:
        report()
        return
    if not args.cell:
        ap.error("--cell is required (or --list / --report)")
    todo = variants(args.cell) if args.all_variants else [args.variant]
    for v in todo:
        path = ARTIFACTS / f"{variant_name(args.cell, v)}.json"
        if args.skip_existing and path.exists() \
                and json.loads(path.read_text()).get("ok"):
            print(f"[{v}] cached ok")
            continue
        run_variant(args.cell, v, args.device)


if __name__ == "__main__":
    main()
