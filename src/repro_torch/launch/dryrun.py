"""Dry run: every (arch x shape) cell's step run on fake tensors (shapes,
types and devices, no allocation), counting its operations, bytes, kernel
launches and memory for the roofline analysis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

The reference lowers and compiles each cell for a TPU mesh and parses the
compiled HLO. The port runs the cell's step once under a
``FakeTensorMode`` with a :class:`roofline.count.Counter`: a training
cell runs ``make_train_step`` (loss, backward, clipping and AdamW, with
the reference's 8 microbatches of gradient accumulation, counted once and
multiplied by 8), a prefill cell ``prefill`` and a decode cell one
``decode_step`` against a cache of ``seq_len`` positions. On ``cuda`` the
kernels' wrappers see fake tensors, return outputs of the right shape and
launch nothing; on the CPU their twins run, muted: both count the same
kernel work, so ``--device cpu`` gives the card's counts without one
(``--device`` defaults to ``cuda``, which raises where there is none).

One card has no mesh: records carry ``chips: 1`` and the device's name.
Records land in ``build/dryrun/<arch>__<shape>__1xH100[__<mode>-pe<n>]
[__<tag>].json``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import fields, replace
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (
    ModelConfig,
    TrainConfig,
    get_config,
    get_shape,
    iter_cells,
)
from repro_torch.kernels._build import BUILD
from repro_torch.models.common import resolve_device
from repro_torch.roofline import hw
from repro_torch.roofline.count import Counter
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

ARTIFACTS = BUILD / "dryrun"
CHIPS = "1xH100"
MODES = ("baseline", "sw", "xqueue", "qlr")


def default_n_pe(cfg: ModelConfig, systolic_mode: str) -> int:
    """The ring a systolic mode runs on: 4 PEs, as the port's launchers
    default; none for ``baseline`` and for the ssm family (no ring)."""
    if systolic_mode == "baseline" or cfg.family == "ssm":
        return 0
    return 4


def cell_name(arch: str, shape_name: str, systolic_mode: str = "baseline",
              n_pe: int = 0, tag: str = "") -> str:
    name = f"{arch}__{shape_name}__{CHIPS}"
    if systolic_mode != "baseline":
        name += f"__{systolic_mode}-pe{n_pe}"
    if tag:
        name += f"__{tag}"
    return name


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (dicts, lists, tuples)."""
    return sum(t.numel() * t.element_size() for t in opt.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _new_bytes(out, args) -> int:
    """Bytes of the storages ``out`` holds that ``args`` does not (a
    decode step's cache is updated in place)."""
    held = {id(t.untyped_storage()) for t in opt.tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    seen, total = set(), 0
    for t in opt.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            key = id(t.untyped_storage())
            if key not in held and key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def count_cell(cfg: ModelConfig, shape, tcfg: TrainConfig, n_pe: int,
               device) -> dict:
    """Run the cell's step once on fake tensors on ``device`` under a
    counter; returns the memory figures and the counts. ``device`` is not
    resolved here: nothing is allocated on it."""
    dev = torch.device(device)
    with FakeTensorMode():
        if shape.kind == "train":
            step = step_lib.make_train_step(cfg, tcfg, n_pe)
            state = step_lib.state_shapes(cfg, tcfg, dev)
            batch, _ = step_lib.batch_shapes(cfg, shape, dev)
            args = (state, batch)
        elif shape.kind == "prefill":
            step = step_lib.make_prefill_step(cfg, n_pe)
            params = step_lib.params_shapes(cfg, dev)
            batch, _ = step_lib.batch_shapes(cfg, shape, dev)
            args = (params, batch)
        else:
            step = step_lib.make_serve_step(cfg, n_pe)
            params = step_lib.params_shapes(cfg, dev)
            cache, _ = step_lib.cache_shapes(cfg, shape, dev)
            batch, _ = step_lib.batch_shapes(cfg, shape, dev)
            args = (params, cache, batch["tokens"], batch["active"])
        arg_bytes = tree_bytes(args)
        with Counter(device=dev, fold_loops=True) as counter:
            counter.hold(args)
            out = step(*args)
        out_bytes = _new_bytes(out, args)
    counts = counter.aggregate()
    peak = arg_bytes + counts.pop("peak_new_bytes")
    return {"memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                       "peak_bytes": peak, "fits": peak <= hw.HBM_BYTES,
                       "device_bytes": hw.HBM_BYTES},
            "counts": counts}


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def run_cell(arch: str, shape_name: str, systolic_mode: str = "baseline",
             n_pe: int | None = None, device="cuda",
             out_dir: Path | None = ARTIFACTS,
             extra_overrides: dict | None = None, tag: str = "",
             train_overrides: dict | None = None) -> dict:
    """Dry-run one cell and write its record to ``out_dir`` (None: keep
    it in memory only). Config overrides naming fields the port does not
    have (the reference's sharding options) make the cell not applicable:
    it is recorded with ``ok: false`` and its reason, and not run."""
    base = get_config(arch)
    if n_pe is None:
        n_pe = default_n_pe(base, systolic_mode)
    name = cell_name(arch, shape_name, systolic_mode, n_pe, tag)
    shape = get_shape(shape_name)
    record = {"cell": name, "arch": arch, "shape": shape_name,
              "kind": shape.kind, "systolic_mode": systolic_mode,
              "n_pe": n_pe, "chips": 1,
              "overrides": {"cfg": extra_overrides or {},
                            "train": train_overrides or {}}}
    known = {f.name for f in fields(ModelConfig)}
    sharding = sorted(set(extra_overrides or {}) - known)
    t0 = time.perf_counter()
    if sharding:
        record.update(ok=False, applicable=False,
                      error=f"not applicable on one card: {sharding} only "
                            "change how the reference shards over its mesh")
        print(f"[{name}] not applicable: {record['error']}")
    else:
        try:
            dev = resolve_device(device)
            cfg = replace(base, systolic_mode=systolic_mode,
                          **(extra_overrides or {}))
            # the reference's production default: 8 microbatches
            tcfg = replace(TrainConfig(microbatches=8),
                           **(train_overrides or {}))
            record.update(
                device=device_name(dev), n_params=cfg.n_params,
                n_active_params=cfg.n_active_params, seq_len=shape.seq_len,
                global_batch=shape.global_batch,
                microbatches=tcfg.microbatches if shape.kind == "train"
                else None,
                attention_pairs="every (query, key) pair of a launch, "
                                "masked or not")
            record.update(count_cell(cfg, shape, tcfg, n_pe, dev))
            record["ok"] = True
            c, m = record["counts"], record["memory"]
            launches = {k: v["launches"] for k, v in c["by_kernel"].items()}
            print(f"[{name}] OK flops={c['flops_per_device']:.4g} "
                  f"bytes={c['hbm_bytes_per_device']:.4g} "
                  f"peak={m['peak_bytes'] / 1e9:.2f} GB kernels={launches} "
                  f"{time.perf_counter() - t0:.1f} s")
        except Exception as e:
            record["ok"] = False
            record["error"] = f"{type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc()[-4000:]
            print(f"[{name}] FAIL {type(e).__name__}: {str(e)[:300]}")
    record["timings"] = {"host_s": time.perf_counter() - t0}
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{name}.json").write_text(
            json.dumps(record, indent=2, default=str))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell")
    ap.add_argument("--systolic-mode", default="baseline", choices=MODES)
    ap.add_argument("--n-pe", type=int, default=None,
                    help="PEs of the emulated ring (default 4 in a link "
                         "mode; 0 for baseline and the ssm family)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default cuda; 'cpu' "
                         "counts the same without a card)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if args.all:
        cells = list(iter_cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        cells = [(args.arch, args.shape)]

    n_ok = 0
    for arch, shape_name in cells:
        n_pe = args.n_pe if args.n_pe is not None else default_n_pe(
            get_config(arch), args.systolic_mode)
        name = cell_name(arch, shape_name, args.systolic_mode, n_pe)
        path = out_dir / f"{name}.json"
        if args.skip_existing and path.exists() \
                and json.loads(path.read_text()).get("ok"):
            n_ok += 1
            print(f"[{name}] skip (cached ok)")
            continue
        rec = run_cell(arch, shape_name, args.systolic_mode, n_pe,
                       args.device, out_dir)
        n_ok += bool(rec.get("ok"))
    print(f"dryrun: {n_ok}/{len(cells)} cells ok")
    raise SystemExit(0 if n_ok == len(cells) else 1)


if __name__ == "__main__":
    main()
