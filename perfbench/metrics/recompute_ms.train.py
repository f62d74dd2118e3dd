"""Device milliseconds a training step spends in remat's recompute: the
port's ``mamba2.block`` spans opened inside ``train.backward``
(``repro_torch.obs.trace``), summed a traced step. None unless a step has
one such span a layer, each with a device time, or on a port that records
no spans."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    layers = ctx["cell"].config["model"]["num_layers"]
    return mean_device_ms(n, "train.step", "mamba2.block", layers,
                          recompute=True)
