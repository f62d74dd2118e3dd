"""Device milliseconds a prefill call spends in the SSD scan around its
kernel: the port's ``mamba2.ssd`` spans (``repro_torch.obs.trace``),
summed a traced call, less the ``ssd_chunks`` kernel's device time of the
same calls in the trace. What is left is the layout copies, the chain of
chunk states, the inter-chunk product and the D term. None when the
kernel is not in the trace, when a call lacks one such span a layer or a
device time for one, or on a port that records no spans."""

KERNEL = "ssd_chunks_kernel"  # every device kernel of an ssd_chunks launch


def read(ctx):
    t = ctx["trace"]
    if not t.calls:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    layers = ctx["cell"].config["model"]["num_layers"]
    ssd = mean_device_ms(t.calls, "prefill.step", "mamba2.ssd", layers)
    kernel_s = sum(s for name, s in t.kernel_s.items() if KERNEL in name)
    if ssd is None or kernel_s <= 0:
        return None
    return ssd - 1e3 * kernel_s / t.calls
