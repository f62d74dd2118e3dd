"""Device milliseconds a training step spends in its optimizer: the
port's ``train.optimizer`` span (``repro_torch.obs.trace``: gradient
compression and decompression, global-norm clipping, AdamW with fp32
masters), a traced step. None without one such span a step, a device
time for it, or a port that records no spans."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    return mean_device_ms(n, "train.step", "train.optimizer")
