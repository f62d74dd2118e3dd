"""``flash_carry_bwd``'s share of its roofline: the bound of its launches
(``perfbench.work.flash_carry_bwd``: one ring attention call's backward
is ``n_pe`` hop launches at the cell's shapes) over the device time of
all their passes in the trace. None unless the launches come in whole
ring calls and the trace holds every one."""
from perfbench.work import flash_carry_bwd as work

KERNEL = "flash_carry_bwd"  # the port's launch counter
TIME = "flash_carry_bwd_kernel"  # every device kernel of a launch
ONCE = "flash_carry_bwd_kernel_rows"  # pass A, once a launch (either body)


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    n, n_pe = ctx["launches"].get(KERNEL, 0), cell.n_pe
    seen = sum(c for name, c in t.kernel_n.items() if ONCE in name)
    spent = sum(s for name, s in t.kernel_s.items() if TIME in name)
    if n == 0 or n_pe < 2 or n % n_pe or seen != n or spent <= 0:
        return None   # not on this path, or the trace lost launches
    tr = cell.traffic
    bound = n // n_pe * work.ring_bound_s(cell.config["model"], tr["batch"],
                                          tr["seq"], n_pe)
    return 100.0 * bound / spent
