"""host_syncs_per_call: the program's host syncs (its ``pcis.sync.*``
spans) in the traced window, a call."""

from benchmark import spans


def read(ctx):
    got = spans.program_spans(ctx)
    if got is None:
        return None
    return sum(n.startswith(spans.SYNC) for n, _, _ in got) / ctx.calls
