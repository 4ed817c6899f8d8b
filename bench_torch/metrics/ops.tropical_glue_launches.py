"""ops.tropical_glue_launches: device operations per traced query launched
inside the tropical engine's glue spans, `tropical.activity` and
`tropical.decode`: what folding the glue into the walks' kernels would
take off the card's queue."""
from trace import Intervals

GLUE = ("tropical.activity", "tropical.decode")


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    glue = [(s, e) for name in GLUE for s, e in t.spans.get(name, [])
            if s >= t.t0 and e <= t.t1]
    if not glue:
        return None
    inside = Intervals(glue)
    ops = 0
    for e in t.gpu:
        ts = t.launch_ts.get(e.get("args", {}).get("correlation"))
        ops += ts is not None and ts in inside
    return ops / t.queries
