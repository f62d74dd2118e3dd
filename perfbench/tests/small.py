"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
configuration's model at the port's SMOKE widths, the traffic at a few
short rows. Everything else (kind, ring, remat, optimizer, limits) is
the cell's own."""
from __future__ import annotations

import copy

from perfbench.lib import bench

SMOKE_FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size", "ssm_state",
                "ssm_headdim", "ssm_chunk", "attn_every", "n_shared_attn")
TRAFFIC = {"train": {"batch": 2, "seq": 32, "pool_calls": 8,
                     "trace_calls": 1},
           "prefill": {"batch": 2, "seq": 32, "pool_calls": 8,
                       "trace_calls": 2, "check_calls": 3,
                       "check_batch": 2}}


WIDE = {"num_layers": 2, "vocab_size": 8192, "ssm_chunk": 16}


def small_cell(name: str, dtype: str | None = None,
               wide: bool = False) -> bench.Cell:
    """``wide`` keeps the configuration's widths (so its logits have their
    full-size scale) and cuts only depth, vocabulary and chunk."""
    from repro_torch.configs import get_smoke_config
    cell = copy.deepcopy(bench.load_cell(name))
    model = cell.config["model"]
    smoke = get_smoke_config(model["name"])
    for f in SMOKE_FIELDS:
        if f in model:
            model[f] = WIDE[f] if wide and f in WIDE else \
                model[f] if wide else getattr(smoke, f)
    if dtype:
        model["dtype"] = model["param_dtype"] = dtype
    cell.traffic.update(TRAFFIC[cell.traffic["kind"]])
    return cell
