"""entry_idle_pct: the share of the traced window in which the card is idle
while the host is inside an entry call (the span its entry driver names,
``SPAN``): the host's own work and waits inside the call."""

from benchmark import spans


def read(ctx):
    got = spans.program_spans(ctx)
    if got is None or ctx.span is None:
        return None
    calls = spans.union((s, e) for n, s, e in got if n == ctx.span)
    if not calls:
        return None
    return 100.0 * spans.overlap_seconds(spans.idle_gaps(ctx), calls) / ctx.window_s
