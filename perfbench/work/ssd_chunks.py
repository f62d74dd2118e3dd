"""``ssd_chunks`` (``csrc/ssd_chunks.cu``): the Mamba2 SSD intra-chunk
pass of one layer, one launch over every (head row, chunk).

Operands: x [BH, NC, L, P] and B, C [BG, NC, L, N] in the activation type,
dt [BH, NC, L, 1] and a [BH, 1, 1, 1] fp32; outputs y [BH, NC, L, P],
states [BH, NC, P, N] and exp(cum) [BH, NC, L, 1], fp32. Operations: the
causal triangle of C Bᵀ once per (group row, chunk), the causal triangle
of M x and the boundary state per (head row, chunk)."""
from __future__ import annotations

from perfbench.lib.peaks import bound_s


def shape(model: dict, batch: int, seq: int) -> dict:
    """One Mamba2 layer's launch at ``batch`` x ``seq`` tokens."""
    heads = model["ssm_expand"] * model["d_model"] // model["ssm_headdim"]
    chunk = min(model["ssm_chunk"], seq)
    return {"bh": batch * heads, "bg": batch * model["ssm_ngroups"],
            "nc": seq // chunk, "l": chunk, "p": model["ssm_headdim"],
            "n": model["ssm_state"]}


def work(bh, bg, nc, l, p, n, itemsize: int = 2):
    """(operations, bytes) of one launch."""
    tri = l * (l + 1) // 2
    flops = bg * nc * 2 * tri * n + bh * nc * (2 * tri * p + 2 * l * p * n)
    inputs = (itemsize * (bh * nc * l * p + 2 * bg * nc * l * n)
              + 4 * (bh * nc * l + bh))
    outputs = 4 * bh * nc * (l * p + p * n + l)
    return flops, inputs + outputs


def launch_bound_s(model: dict, batch: int, seq: int) -> float:
    """The bound of one launch of a cell's shape, bf16 on the tensor
    cores."""
    return bound_s(*work(**shape(model, batch, seq)), "bf16")
