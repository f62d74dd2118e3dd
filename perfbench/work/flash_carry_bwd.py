"""``flash_carry_bwd`` (``csrc/flash_carry_bwd.cu``): the gradient of one
``flash_carry`` hop, all its passes.

Operations: 12·D per live (query, head, key) pair (the forward's two
products recomputed, four more for the gradients). Bytes: each input read
once (q, K, V, the state, the saved outputs, the cotangents) and each
output written once (dq, dK, dV, the state's gradients). Hops and live
pairs as in ``flash_carry``."""
from __future__ import annotations

from perfbench.lib.peaks import bound_s
from perfbench.work.flash_carry import hop_shape, live_pairs


def work(rows, sq, h, kvh, d, pairs, itemsize: int = 2):
    """(operations, bytes) of one backward launch with fp32 state."""
    moved = (2 * itemsize * rows * sq * h * d
             + 4 * itemsize * rows * sq * kvh * d
             + 8 * 4 * rows * h * sq + 4 * 4 * rows * h * sq * d)
    return 12 * d * h * pairs, moved


def ring_bound_s(model: dict, batch: int, seq: int, n_pe: int) -> float:
    """Σ of the hops' bounds of one ring attention call's backward."""
    s = hop_shape(model, batch, seq, n_pe)
    return sum(bound_s(*work(**s, pairs=live_pairs(n_pe, batch, s["sq"], t)),
                       "bf16") for t in range(n_pe))
