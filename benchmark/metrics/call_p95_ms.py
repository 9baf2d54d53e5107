"""call_p95_ms: the 95th percentile of every call's latency in the window,
from dispatch to the end of its readback (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
