"""``ssd_chunks_bwd``'s share of its roofline: the bound of its launches
(``perfbench.work.ssd_chunks_bwd`` at the cell's shapes, one launch a
Mamba2 layer) over the device time of all their passes in the trace."""
from perfbench.work import ssd_chunks_bwd as work

KERNEL = "ssd_chunks_bwd"  # the port's launch counter
TIME = "ssd_bwd_"  # every device kernel of a launch
ONCE = "ssd_bwd_kernel"  # the device kernel each launch runs once


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    n = ctx["launches"].get(KERNEL, 0)
    seen = sum(c for name, c in t.kernel_n.items() if ONCE in name)
    spent = sum(s for name, s in t.kernel_s.items() if TIME in name)
    if n == 0 or seen != n or spent <= 0:
        return None   # not on this path, or the trace lost launches
    tr = cell.traffic
    bound = n * work.launch_bound_s(cell.config["model"], tr["batch"],
                                   tr["seq"])
    return 100.0 * bound / spent
