"""mps: megapixels of all calls completed in the window over its seconds
(host clock)."""


def read(ctx):
    return ctx.calls * ctx.megapixels / ctx.window_s
