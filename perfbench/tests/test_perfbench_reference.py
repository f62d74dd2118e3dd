"""The reference against the port's CPU path at each configuration's SMOKE
widths, in fp32: the same last-position logits and the same loss and
gradients from the same parameters and tokens."""
import pytest
import torch

from perfbench.lib import drive, tree, weights
from perfbench.reference import common as ref_ops
from small import small_cell

CELLS = ("mamba2-1.3b.train",)   # one a configuration


def _inputs(cell, seed=7):
    gen = torch.Generator().manual_seed(seed)
    v = cell.config["model"]["vocab_size"]
    return torch.randint(0, v, (2, 33), generator=gen)


@pytest.mark.parametrize("name", CELLS)
def test_last_logits_match_the_port(name):
    from repro_torch.train import step
    cell = small_cell(name, "float32")
    cfg = cell.model_config()
    params = weights.make(cfg, 3, "cpu")
    tokens = _inputs(cell)[:, :32]
    got = step.make_prefill_step(cfg, cell.n_pe)(params, {"tokens": tokens})
    ref_ops.strict_fp32()
    want = drive.reference_model(cell).last_logits(
        params, tokens, cell.config["model"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import build_model
    cell = small_cell(name, "float32")
    cfg = cell.model_config()
    params = weights.make(cfg, 4, "cpu")
    rows = _inputs(cell)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    paths = [p for p, _ in tree.leaves(params)]
    mine = [t.clone().requires_grad_(True) for _, t in tree.leaves(params)]
    model = build_model(cfg, n_pe=cell.n_pe)
    loss, _ = model.loss(tree.rebuild(params, dict(zip(paths, mine))), batch)
    got = torch.autograd.grad(loss, mine)
    theirs = [t.clone().requires_grad_(True) for _, t in tree.leaves(params)]
    want_loss = drive.reference_model(cell).loss(
        tree.rebuild(params, dict(zip(paths, theirs))), batch["tokens"],
        batch["targets"], cell.config["model"])
    want = torch.autograd.grad(want_loss, theirs)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    for p, g, w in zip(paths, got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, p
