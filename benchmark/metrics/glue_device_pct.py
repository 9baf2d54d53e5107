"""glue_device_pct: device time of the kernels the port does not build
from ``csrc/`` (PyTorch's own, the tensor code between the port's kernels)
over the device's busy time in the traced window."""

from benchmark import devtrace


def read(ctx):
    if not ctx.busy_s:
        return None
    lo, hi = ctx.window
    glue = sum(min(e, hi) - max(s, lo) for name, s, e in ctx.trace.kernels
               if e > lo and s < hi
               and not devtrace.is_program_kernel(name, ctx.program_names, ctx.program_spaces))
    return 100.0 * glue / ctx.busy_s
