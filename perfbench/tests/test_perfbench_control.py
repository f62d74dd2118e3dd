"""The control at a size the CPU holds: the reference computed a precision
below the configuration's (fp8 weight products for bf16) in the
program's place. On the card, at the cells' own sizes and on three seeds
or more, ``perfbench/calibrate.py`` reads it; here, at the SMOKE widths
with the program in fp32:

* training: the control comes out not correct by the cell's limits,
  while the program's run does;
* prefill: the control's widest logit gap is many times the program's
  (SMOKE's logits are several times smaller than the full model's, so
  the full-size limit does not apply at this width).
"""
import time

import pytest
import torch

from perfbench.lib import check, drive
from small import small_cell


def _run(cell, seed):
    res = drive.run(cell, seed, 1.0, False, torch.device("cpu"),
                    time.perf_counter())
    return res, res["_kind"].control()


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_training_control_is_not_correct(seed):
    cell = small_cell("mamba2-1.3b.train", "float32")
    res, control = _run(cell, seed)
    assert res["correct"], res["checks"]
    ok, checks = check.judge(control, cell.limits["limits"])
    assert not ok, checks


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_prefill_control_reads_far_above_the_program(seed):
    cell = small_cell("mamba2-1.3b.prefill", "float32")
    cell.traffic.update({"batch": 32, "pool_calls": 8, "check_calls": 4,
                         "check_batch": 16})
    res, control = _run(cell, seed)
    assert res["numbers"]["where"]["tokens"] == 32 * min(4, res["attempted"])
    assert control["logit_gap"] > max(0.02, 10 * res["numbers"]["logit_gap"])


@pytest.mark.cuda
@pytest.mark.parametrize("name,seconds", [("mamba2-1.3b.train", 1.0),
                                          ("mamba2-1.3b.prefill", 8.0)])
def test_the_control_fails_on_the_card(card, name, seconds):
    """At the cell's own sizes, on three seeds: the control is not
    correct by the cell's limits, the program is."""
    from perfbench.lib import bench
    cell = bench.load_cell(name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = drive.run(cell, seed, seconds, False, card, time.perf_counter())
        assert res["correct"], res["checks"]
        ok, checks = check.judge(res["_kind"].control(),
                                 cell.limits["limits"])
        assert not ok, checks
        del res
        torch.cuda.empty_cache()
