"""peak_mem_gib: the card's peak allocated memory over the window, staged
inputs included (the caching allocator's statistics, reset after set-up)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
