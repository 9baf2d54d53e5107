"""The program's own spans in a traced window: the ``pcis.*`` annotations
of the port's tracer (``utils/profiling.py``), found by their prefix in
any host category.  Each entry driver names the span of its calls
(``entries/<entry>.py``, ``SPAN``); a ``pcis.sync.*`` span is a place where
the host waits on the card.  A program that annotates nothing leaves the
readers nothing to read.
"""

from __future__ import annotations

import bisect

from benchmark import devtrace

PREFIX = "pcis."
SYNC = "pcis.sync."


def program_spans(ctx):
    """(name, start, end) of the ``pcis.`` host spans that start in the
    window, or None where there are none."""
    lo, hi = ctx.window
    got = [(n, s, e) for _, n, s, e in ctx.trace.host if n.startswith(PREFIX) and lo <= s < hi]
    return got or None


def union(intervals) -> list:
    """Sorted disjoint (start, end) covering ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def overlap_seconds(a, b) -> float:
    """Seconds covered by both of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(ctx) -> list:
    """The window's stretches with no device activity."""
    return devtrace.idle_gaps(ctx.busy, *ctx.window)


def opened_inside(gaps, spans) -> list:
    """The gaps whose start lies inside one of the sorted disjoint
    ``spans``."""
    starts = [s for s, _ in spans]
    out = []
    for g in gaps:
        k = bisect.bisect_right(starts, g[0]) - 1
        if k >= 0 and g[0] < spans[k][1]:
            out.append(g)
    return out
