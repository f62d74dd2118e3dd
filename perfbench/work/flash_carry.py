"""``flash_carry`` (``csrc/flash_carry.cu``): one ring hop of attention,
folding an arriving K/V block into each query row's carried (m, l, acc).

On a ring of ``n`` PEs over ``batch`` rows of ``seq`` tokens, a hop is one
launch over n·batch query rows of sq = seq / n queries (heads whole). On
the +1 ring PE d holds at hop t the K/V shard that started on PE
(d - t) mod n: under a causal mask its queries see all of it when that
shard lies before its own, the causal triangle at t = 0, nothing after.

Forward operations: 4·D per live (query, head, key) pair (Q·Kᵀ and P·V).
Bytes: the queries, the K and V of the keys read, the state in and out."""
from __future__ import annotations

from perfbench.lib.peaks import bound_s


def hop_shape(model: dict, batch: int, seq: int, n_pe: int) -> dict:
    h = model["num_heads"]
    return {"rows": n_pe * batch, "sq": seq // n_pe, "h": h,
            "kvh": model["num_kv_heads"],
            "d": model.get("head_dim") or model["d_model"] // h}


def live_pairs(n_pe: int, batch: int, sq: int, hop: int) -> int:
    """Live causal (query, key) pairs of hop ``hop`` over all rows."""
    tri, full = sq * (sq + 1) // 2, sq * sq
    per_row = sum(tri if (d - hop) % n_pe == d
                  else full if (d - hop) % n_pe < d else 0
                  for d in range(n_pe))
    return batch * per_row


def work(rows, sq, h, kvh, d, pairs, itemsize: int = 2):
    """(operations, bytes) of one forward launch with fp32 state."""
    q = rows * sq * h * d
    moved = (itemsize * q + 4 * (2 * rows * h * sq + rows * h * sq * d)
             + rows * sq * kvh * d * 2 * itemsize
             + 4 * 2 * rows * h * sq + 4 * rows * h * sq * d)
    return 4 * d * h * pairs, moved


def ring_bound_s(model: dict, batch: int, seq: int, n_pe: int) -> float:
    """Σ of the hops' bounds of one ring attention call (n_pe launches)."""
    s = hop_shape(model, batch, seq, n_pe)
    return sum(bound_s(*work(**s, pairs=live_pairs(n_pe, batch, s["sq"], t)),
                       "bf16") for t in range(n_pe))
