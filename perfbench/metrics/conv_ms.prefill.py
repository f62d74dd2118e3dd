"""Device milliseconds a prefill call spends in the Mamba2 causal conv:
the port's ``mamba2.conv`` spans (``repro_torch.obs.trace``), summed a
traced call. None unless a call has one such span a layer, each with a
device time, or on a port that records no spans."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    layers = ctx["cell"].config["model"]["num_layers"]
    return mean_device_ms(n, "prefill.step", "mamba2.conv", layers)
