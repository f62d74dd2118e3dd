"""Device milliseconds a training step spends in its forward: the port's
``train.forward`` span (``repro_torch.obs.trace``: the model's loss, the
head and cross-entropy included), a traced step. None without one such
span a step, a device time for it, or a port that records no spans."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    return mean_device_ms(n, "train.step", "train.forward")
