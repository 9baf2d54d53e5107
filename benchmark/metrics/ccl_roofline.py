"""ccl_roofline: K2's least time over its device time in the traced window.

K2's CUDA kernels are named in ``kernels.json``; an invocation launches its
invocation kernel once, whose template argument is the input's element
type.  Every K2 invocation of these entries labels the call's whole
[B, H, W] batch, so each one's least bytes are its input read once and its
int32 labels written once at that size.
"""

import math

from benchmark import devtrace, roofline


def read(ctx):
    names = set(ctx.kernels["kernels"]["K2"])
    invocation = ctx.kernels["invocation"]["K2"]
    sizes = ctx.kernels["element_bytes"]
    px = math.prod(ctx.shape)
    lo, hi = ctx.window
    seconds, nbytes = 0.0, 0
    for name, s, e in ctx.trace.kernels:
        if s < lo or e > hi or not devtrace.is_program_kernel(
                name, ctx.program_names, ctx.program_spaces):
            continue
        base = devtrace.kernel_base(name).split("::")[-1]
        if base not in names:
            continue
        seconds += e - s
        if base == invocation:
            element = sizes.get(devtrace.template_args(name).strip())
            if element is None:
                return None
            nbytes += roofline.k2_bytes(px, element)
    if not seconds or not nbytes:
        return None
    return 100.0 * roofline.least_seconds(nbytes) / seconds
