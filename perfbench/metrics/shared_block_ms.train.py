"""Device milliseconds a training step spends in the shared blocks of the
published Zamba2: the port's ``zamba2.shared`` spans
(``repro_torch.obs.trace``), one a call in the forward and one a call in
remat's recompute, summed a traced step. None unless a step has that
many, each with a device time, or on a port that records no such spans
(a configuration without hybrid layers has none)."""


def read(ctx):
    n = ctx["trace"].calls
    if not n:
        return None
    try:
        from repro_torch.obs.trace import mean_device_ms
    except ImportError:
        return None
    m = ctx["cell"].config["model"]
    calls = sum(i < m["num_layers"] for i in m.get("hybrid_layer_ids", ()))
    if not calls:
        return None
    runs = 1 if m.get("remat", "full") == "none" else 2
    return mean_device_ms(n, "train.step", "zamba2.shared", runs * calls)
