"""Device milliseconds a training step spends in its backward: the port's
``train.backward`` span (``repro_torch.obs.trace``: ``torch.autograd.grad``,
remat's recompute of every block inside it), a traced step. None without
one such span a step, a device time for it, or a port that records no
spans."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    return mean_device_ms(n, "train.step", "train.backward")
