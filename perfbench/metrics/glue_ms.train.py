"""Device milliseconds a training step spends in glue: kernels that are
neither the port's hand-written kernels nor matrix-product library
kernels (``perfbench.lib.kernel_names``), summed over the traced steps."""
from perfbench.lib import kernel_names


def read(ctx):
    t = ctx["trace"]
    if not t.calls or not t.kernel_s:
        return None
    glue = sum(s for name, s in t.kernel_s.items()
               if kernel_names.kind(name) == "glue")
    return 1e3 * glue / t.calls
