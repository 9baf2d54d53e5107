"""hist_roofline: the Otsu histogram kernel's least time over its device
time in the traced window.

The kernel is ``histogram_kernel`` (``kernels.json``'s K4; one launch a
call of the histogram at the entries' ``bins`` ≤ 16384), over the call's
whole float32 [B, H, W] batch: its least bytes are each pixel read once
(4 B) and each plane's int32 counts written once (4 B a bin).
"""

import math

from benchmark import devtrace, roofline

KERNEL = "histogram_kernel"
PIXEL_BYTES = 4  # float32
BIN_BYTES = 4  # int32


def read(ctx):
    B, px = ctx.shape[0], math.prod(ctx.shape)
    lo, hi = ctx.window
    seconds, nbytes = 0.0, 0
    for name, s, e in ctx.trace.kernels:
        if s < lo or e > hi or devtrace.kernel_base(name).split("::")[-1] != KERNEL:
            continue
        if not devtrace.is_program_kernel(name, ctx.program_names, ctx.program_spaces):
            continue
        seconds += e - s
        nbytes += px * PIXEL_BYTES + B * ctx.options["bins"] * BIN_BYTES
    if not seconds:
        return None
    return 100.0 * roofline.least_seconds(nbytes) / seconds
