"""A run with the timed path broken underneath comes out not correct: each
fault of the cell's traffic kind (``perfbench/kinds/<kind>.py``),
planted in the port, at the cells' SMOKE widths on the CPU in fp32, judged by the
cells' own limits (the prefill cell at its full widths, two layers and
8,192 tokens of vocabulary, so that its logits have their full-size
scale). The same run unbroken comes out correct (in fp32: at SMOKE
widths bf16's rounding is not averaged over full-size leaves, so the
full-size limits are not its). The harness's look for a card is
skipped by driving ``drive.run`` directly."""
import time

import pytest
import torch

from perfbench import faults, kinds
from perfbench.lib import drive
from small import small_cell

CELLS = {"mamba2-1.3b.train": "train", "mamba2-1.3b.prefill": "prefill"}
CASES = [(cell, f) for cell, kind in CELLS.items()
         for f in (None, *kinds.load(kind).FAULTS)]


def _run(cell):
    return drive.run(cell, 2**31 + 21, 0.2, False, torch.device("cpu"),
                     time.perf_counter())


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_is_not_correct(name, fault):
    cell = small_cell(name, "float32", wide=CELLS[name] == "prefill")
    if fault is None:
        assert _run(cell)["correct"]
        return
    with faults.planted(fault, cell.traffic["kind"]):
        res = _run(cell)
    assert not res["correct"], res["checks"]
