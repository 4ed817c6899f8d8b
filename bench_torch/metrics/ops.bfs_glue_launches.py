"""ops.bfs_glue_launches: device operations per traced query launched
inside BFS's glue spans, `router.activity`, `router.epilogue` and
`bfs.assign`: what folding the glue into the walks' kernels would take
off the card's queue."""
from trace import Intervals

GLUE = ("router.activity", "router.epilogue", "bfs.assign")


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
