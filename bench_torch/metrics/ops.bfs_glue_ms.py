"""ops.bfs_glue_ms: host milliseconds per traced query inside BFS's glue
spans: `router.activity` (SpMSpV's tile activity flags),
`router.epilogue` (the ANDOR 0/1 clamp and the SpMV mask after each
walk) and `bfs.assign` (the level stamp and the push step's frontier
count): torch ops around the walks, counted as no kernel launch."""
from trace import Intervals

GLUE = ("router.activity", "router.epilogue", "bfs.assign")


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    glue = [(s, e) for name in GLUE for s, e in t.spans.get(name, [])
            if s >= t.t0 and e <= t.t1]
    return Intervals(glue).total() * 1e-3 / t.queries if glue else None
