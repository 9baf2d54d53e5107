"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
