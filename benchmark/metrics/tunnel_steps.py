"""tunnel_steps: steps of the tunnelled phase 2 a call
(``claim_labels.last_steps`` after each traced call)."""


def read(ctx):
    got = [c["tunnel_steps"] for c in ctx.per_call if c.get("tunnel_steps")]
    return sum(got) / len(got) if got else None
