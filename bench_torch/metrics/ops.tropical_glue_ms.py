"""ops.tropical_glue_ms: host milliseconds per traced query inside the
tropical engine's glue spans, `tropical.activity` (SpMSpV's tile
activity) and `tropical.decode` (the decode and mask after each walk):
torch ops around the walks, counted as no kernel launch."""
from trace import Intervals

GLUE = ("tropical.activity", "tropical.decode")


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    glue = [(s, e) for name in GLUE for s, e in t.spans.get(name, [])
            if s >= t.t0 and e <= t.t1]
    return Intervals(glue).total() * 1e-3 / t.queries if glue else None
