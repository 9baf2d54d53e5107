"""sync_idle_pct: the share of the traced window in idle gaps that open
while the host is inside a host sync (a ``pcis.sync.*`` span), each to its
end: the card waiting for the host to read back and enqueue again."""

from benchmark import spans


def read(ctx):
    got = spans.program_spans(ctx)
    if got is None:
        return None
    syncs = spans.union((s, e) for n, s, e in got if n.startswith(spans.SYNC))
    idle = spans.opened_inside(spans.idle_gaps(ctx), syncs)
    return 100.0 * sum(e - s for s, e in idle) / ctx.window_s
