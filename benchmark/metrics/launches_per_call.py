"""launches_per_call: launches of the port's kernel wrappers (K1-K12, the
blur; ``_kernels.launch_counters``) over the traced calls, a call."""


def read(ctx):
    n = sum(ctx.launches.values()) if ctx.launches else 0
    return n / ctx.calls if n else None
