"""The share of the traced prefill calls' window in which no kernel ran on
the card."""


def read(ctx):
    t = ctx["trace"]
    if not t.calls or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
