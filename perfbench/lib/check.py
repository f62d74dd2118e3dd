"""The numbers that decide ``correct``, each against its limit.

Training (``train``): the reference follows the program's first
``check_steps`` steps from the same parameters and batches. For each leaf
of the parameter tree, the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger:

* ``grad_gap``: the median leaf's gap of the first step's clipped
  gradient as the optimizer got it (the worst leaf's, ``grad_gap_worst``,
  is the noise of one 64-element per-head leaf and swings from seed to
  seed, so it is reported, not compared);
* ``change_gap``: the worst leaf's gap of the parameters' change over the
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient moves by
  weight decay and round-off alone);
* ``loss_gap``: each step's relative loss gap, reported and not compared:
  neither the control nor any fault reads three times the program's.

Prefill (``prefill``): ``logit_gap``, the widest gap by which a served
token's logit lies below the reference's largest logit of its prompt.
"""
from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def leaf_gaps(got: dict, want: dict, paths) -> dict:
    """Each leaf's gap of norms; NaN reads as infinite."""
    floor = statistics.median(want[p] for p in paths)
    gaps = {}
    for p in paths:
        g = abs(got[p] - want[p]) / max(want[p], floor, 1e-30)
        gaps[p] = g if math.isfinite(g) else math.inf
    return gaps


def train(program: dict, reference: dict) -> dict:
    loss_gaps = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
                 else math.inf
                 for p, r in zip(program["loss"], reference["loss"])]
    paths = list(reference["grad"])
    grad = leaf_gaps(program["grad"], reference["grad"], paths)
    floor = statistics.median(reference["grad"].values())
    moved = [p for p in paths if reference["grad"][p] >= SMALL_GRAD * floor]
    change = leaf_gaps(program["change"], reference["change"], moved)
    worst_grad = max(paths, key=grad.get)
    worst_change = max(moved, key=change.get)
    return {"grad_gap": statistics.median(grad.values()),
            "change_gap": change[worst_change],
            "grad_gap_worst": grad[worst_grad], "loss_gap": max(loss_gaps),
            "where": {"grad_gap_worst": ".".join(worst_grad),
                      "change_gap": ".".join(worst_change),
                      "loss_gaps": loss_gaps,
                      "leaves_left_out": len(paths) - len(moved)}}


def logit_gaps(ref_logits, served) -> list:
    """Per row: the reference's largest logit minus its logit of the
    served token. ref_logits [R, V] fp32, served [R] ids."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, served[:, None].to(ref_logits.device))[:, 0]
    return (best - got).tolist()


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
