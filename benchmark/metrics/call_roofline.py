"""call_roofline: a call's least time (its inputs read once and its outputs
written once, ``roofline.CALL_BYTES``) over its device busy time in the
traced window: the whole call's share of the card's bandwidth peak."""

from benchmark import roofline


def read(ctx):
    count = roofline.CALL_BYTES.get(ctx.entry)
    if count is None or not ctx.busy_s:
        return None
    least = roofline.least_seconds(count(*ctx.shape, ctx.options))
    return 100.0 * least / (ctx.busy_s / ctx.calls)
