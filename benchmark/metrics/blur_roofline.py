"""blur_roofline: the blur kernel's least time over its device time in the
traced window.

The blur's CUDA kernels are ``kernels.json``'s ``blur`` (the register ring
and the shared window; one launch a call of ``gaussian_blur``), each
named with its pixel type as its last template argument.  Every blur of
these entries covers the call's whole [B, H, W] batch, so each launch's
least bytes are a pixel read once at its type's size and written once as
float32.
"""

import math

from benchmark import devtrace, roofline

# the blur's input types, as a demangled template argument names them
PIXEL_BYTES = {"unsigned short": 2, "float": 4}
OUT_BYTES = 4  # float32


def read(ctx):
    names = set(ctx.kernels["kernels"]["blur"])
    px = math.prod(ctx.shape)
    lo, hi = ctx.window
    seconds, nbytes = 0.0, 0
    for name, s, e in ctx.trace.kernels:
        if s < lo or e > hi or not devtrace.is_program_kernel(
                name, ctx.program_names, ctx.program_spaces):
            continue
        if devtrace.kernel_base(name).split("::")[-1] not in names:
            continue
        element = PIXEL_BYTES.get(devtrace.template_args(name).split(",")[-1].strip())
        if element is None:
            return None
        seconds += e - s
        nbytes += px * (element + OUT_BYTES)
    if not seconds:
        return None
    return 100.0 * roofline.least_seconds(nbytes) / seconds
