"""otsu_launches: the kernel launches that the host makes inside the
program's Otsu step (its ``pcis.threshold.otsu`` spans: each plane's
range, the histogram, the bin centres, the prefix sums and the argmax)
in the traced window, a call.

A launch is a CUDA runtime ``cudaLaunchKernel*`` or ``cudaGraphLaunch*``
event (a graph's replay, however many kernels it holds, is one launch of
the host's), or a driver ``cuLaunchKernel*`` event that no such runtime
event holds, starting inside one of those spans.  A window with no launch
at all (no device) reads nothing.
"""

import bisect

from benchmark import spans

SPAN = "pcis.threshold.otsu"
RUNTIME, DRIVER = ("cudaLaunchKernel", "cudaGraphLaunch"), "cuLaunchKernel"


def read(ctx):
    got = spans.program_spans(ctx)
    if got is None:
        return None
    otsu = spans.union((s, e) for n, s, e in got if n == SPAN)
    if not otsu:
        return None
    lo, hi = ctx.window
    runtime = sorted((s, e) for c, n, s, e in ctx.trace.host
                     if c == "cuda_runtime" and n.startswith(RUNTIME) and lo <= s < hi)
    held = spans.union(runtime)
    starts = [s for s, _ in held]

    def inside_runtime(s, e):
        k = bisect.bisect_right(starts, s) - 1
        return k >= 0 and e <= held[k][1]

    driver = [(s, e) for c, n, s, e in ctx.trace.host
              if c == "cuda_driver" and n.startswith(DRIVER) and lo <= s < hi
              and not inside_runtime(s, e)]
    launches = sorted((s, s) for s, _ in runtime + driver)
    if not launches:
        return None
    return len(spans.opened_inside(launches, otsu)) / ctx.calls
