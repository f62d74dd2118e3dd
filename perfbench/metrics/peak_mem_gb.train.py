"""The most device memory the training window held:
``torch.cuda.max_memory_allocated`` over the window (reset when it
opens), in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx["memory_peak_bytes"]
    return peak / 1e9 if peak else None
