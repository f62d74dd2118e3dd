"""Numeric guardrails: finite (NaN/Inf) checks on ring outputs and logits,
the port of the reference's ``repro/core/guard.py``.

Checked links (``core/queues.py``) catch faults *on* the links; this module
catches what comes out the other end: a corrupted payload that already
folded into an online-softmax state, a logit row that blew up. The
device-side check is one reduction; the host-side check raises with the
offending leaf paths so serving logs say *which* operand went bad.

The serving health monitor (``serve/health.py``) uses :func:`row_finite`
to isolate the poisoned request rows of a decode batch instead of
discarding the whole step.
"""
from __future__ import annotations

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    """A guarded value contained NaN/Inf."""


def _flatten(tree, path: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, paths in
    the reference's ``keystr`` form (``['k'][0]``)."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    return [pair for key, v in items for pair in _flatten(v, path + key)]


def all_finite(tree) -> torch.Tensor:
    """Device-side: 0-d bool, True iff every float leaf is finite. Integer
    leaves are ignored (always finite)."""
    ok = torch.ones((), dtype=torch.bool)
    for _, leaf in _flatten(tree):
        leaf = torch.as_tensor(leaf)
        if leaf.is_floating_point():
            ok = ok.to(leaf.device) & torch.isfinite(leaf).all()
    return ok


def row_finite(logits) -> np.ndarray:
    """Host-side: [B] bool — which rows of a [B, V] logit batch are fully
    finite. The serve monitor evicts the rows that are not."""
    if isinstance(logits, torch.Tensor):
        return torch.isfinite(logits).all(dim=-1).cpu().numpy()
    return np.isfinite(np.asarray(logits, np.float32)).all(axis=-1)


def check_finite(tree, name: str = "value") -> None:
    """Host-side: raise :class:`NonFiniteError` naming every non-finite
    leaf (by path) of ``tree``; no-op when all leaves are finite."""
    bad = []
    for path, leaf in _flatten(tree):
        leaf = torch.as_tensor(leaf)
        if not leaf.is_floating_point():
            continue
        n_bad = int((~torch.isfinite(leaf)).sum())
        if n_bad:
            bad.append(f"{path}: {n_bad}/{leaf.numel()} non-finite")
    if bad:
        raise NonFiniteError(f"{name} contains non-finite values — "
                             + "; ".join(bad))
