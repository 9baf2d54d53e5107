"""call_roofline: a call's least time (its inputs read once and its outputs
written once, as its entry driver's ``CALL_BYTES`` counts them) over its
device busy time in the traced window: the whole call's share of the
card's bandwidth peak."""

from benchmark import roofline


def read(ctx):
    if ctx.call_bytes is None or not ctx.busy_s:
        return None
    least = roofline.least_seconds(ctx.call_bytes(*ctx.shape, ctx.options))
    return 100.0 * least / (ctx.busy_s / ctx.calls)
