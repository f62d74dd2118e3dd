"""``ssd_chunks_bwd`` (``csrc/ssd_chunks_bwd.cu``): the gradient of one
``ssd_chunks`` launch, all its passes.

Operations: C Bᵀ on the causal triangle once per (group row, chunk); per
(head row, chunk) the triangles of gy xᵀ, Mᵀ gy, dCB B and dCBᵀ C, and the
two full products B gsᵀ and x gs. Bytes: the five inputs and the three
fp32 cotangents read once, the five gradients written once."""
from __future__ import annotations

from perfbench.lib.peaks import bound_s
from perfbench.work.ssd_chunks import shape


def work(bh, bg, nc, l, p, n, itemsize: int = 2):
    """(operations, bytes) of one launch."""
    tri = l * (l + 1) // 2
    flops = bg * nc * 2 * tri * n + bh * nc * (2 * tri * (2 * p + 2 * n)
                                               + 4 * l * p * n)
    inputs = (itemsize * (bh * nc * l * p + 2 * bg * nc * l * n)
              + 4 * (bh * nc * l + bh))
    moved = 2 * inputs + 4 * bh * nc * (l * p + p * n + l)
    return flops, moved


def launch_bound_s(model: dict, batch: int, seq: int) -> float:
    return bound_s(*work(**shape(model, batch, seq)), "bf16")
