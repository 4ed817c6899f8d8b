"""device.idle_pct: the share of the traced slice in which no operation
ran on the card, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0 or not t.gpu:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
