"""ws_passes: passes of both watershed phases (K10, K11) a call, from the
PhaseLogs each traced call left (``watershed_cuda.last_logs``)."""


def read(ctx):
    got = [c["ws_passes"] for c in ctx.per_call if "ws_passes" in c]
    return sum(got) / len(got) if got else None
