"""Halo exchange for the hybrid conv2d execution model, on the emulated PE
axis.

Paper (§V-B): each chain PE computes output rows i..i+r; rows i-1..i come
in through systolic links (pops from the upstream PE), rows i+1..i+2 are
loaded from shared memory, and the rows needed downstream are pushed
onward. Here the image rows are split over a leading PE dimension
``[n, r, W]``; the halo rows at block boundaries arrive with one hop each
way over the ring, and the conv kernel (``kernels/conv2d``) reads them as
separate rows beside the block, so no extended copy of the image is built.
``halo_traffic`` accounts the traffic classes as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core import queues
from repro_torch.core.topology import ring
from repro_torch.kernels.conv2d.kernel import conv2d_3x3
from repro_torch.kernels.conv2d.ops import conv2d


def exchange_halo(x_local, n: int, halo: int = 1, mode: str = "qlr"):
    """x_local: [n, r, W] -> (top_in, bot_in), each [n, halo, W]: PE d
    pops its top halo from PE d-1's bottom rows and its bottom halo from
    PE d+1's top rows; the true image edges get zeros. The reference
    returns the two concatenated around x_local."""
    queues.check_mode(mode)
    if x_local.shape[0] != n or not 1 <= halo <= x_local.shape[1]:
        raise ValueError(f"exchange_halo: {tuple(x_local.shape)} does not "
                         f"hold {n} PEs of at least {halo} rows")
    top_in = queues.hop(ring("pe", n, step=1), x_local[:, -halo:], mode, t=0)
    bot_in = queues.hop(ring("pe", n, step=-1), x_local[:, :halo], mode,
                        t=0)
    top_in[0] = 0
    bot_in[n - 1] = 0
    return top_in, bot_in


def conv2d_3x3_local(x_local, top, bot, kernel):
    """Valid 3x3 conv over halo-extended row blocks, one kernel launch for
    all PEs. x_local: [n, r, W]; top/bot: [n, 1, W] (None = zero rows);
    kernel: [3, 3]. Columns are zero-padded; the accumulator is fp32, as in
    the reference's Pallas kernel."""
    return conv2d_3x3(x_local, top, bot, kernel)


def conv2d_systolic(x, kernel, n_pe: int, mode: str = "qlr"):
    """Hybrid systolic conv2d: image rows split over ``n_pe`` PEs; halo
    rows travel the neighbour links; interior rows are local loads; each PE
    stores its own output rows. Zero-padded 3x3. x: [H, W] -> [H, W].

    ``baseline`` is the shared-memory form: one launch over the whole image
    (P = 1), no hops. Every mode gives identical values."""
    queues.check_mode(mode, baseline=True)
    h, w = x.shape
    if h % n_pe:
        raise ValueError(f"conv2d_systolic: {h} rows do not split over "
                         f"{n_pe} PEs")
    if mode == "baseline":
        return conv2d(x, kernel)
    x_local = x.reshape(n_pe, h // n_pe, w)
    top, bot = exchange_halo(x_local, n_pe, 1, mode)
    return conv2d_3x3_local(x_local, top, bot, kernel).reshape(h, w)


def halo_traffic(rows: int, cols: int, n_pes: int, n_chains: int,
                 halo: int = 1, itemsize: int = 4) -> dict:
    """Traffic classes for the hybrid conv2d (per full image):

    systolic_bytes — halo rows over chain-internal links,
    shared_bytes   — chain-boundary halos + interior row loads + output
                     stores through the shared-memory path.
    """
    halo_rows_total = 2 * halo * (n_pes - 1)          # boundary exchanges
    chain_boundary = 2 * halo * (n_chains - 1) if n_chains > 1 else 0
    systolic_rows = halo_rows_total - chain_boundary
    row_bytes = cols * itemsize
    return {
        "systolic_bytes": systolic_rows * row_bytes,
        "shared_bytes": (chain_boundary + rows + rows) * row_bytes,
        "n_links": systolic_rows,
    }


def conv2d_ref(x, kernel):
    """Oracle: zero-padded 3x3 convolution (plain torch, in x's type)."""
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    h, w = x.shape
    out = torch.zeros_like(x)
    for dr in range(3):
        for dc in range(3):
            out = out + kernel[dr, dc] * xp[dr:dr + h, dc:dc + w]
    return out
