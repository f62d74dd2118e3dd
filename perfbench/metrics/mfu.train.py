"""The whole training step's share of the card's bf16 peak: the model FLOPs
(``perfbench.lib.flops``) of the traced steps over the traced window's
seconds times 989 TFLOP/s."""
from perfbench.lib import flops, peaks


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    if not t.calls or t.window_s <= 0:
        return None
    done = flops.per_call(cell.config, cell.traffic) * t.calls
    return 100.0 * done / (t.window_s * peaks.PEAK_FLOPS["bf16"])
