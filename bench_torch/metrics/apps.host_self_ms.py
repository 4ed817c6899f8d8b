"""apps.host_self_ms: the app layer's own host milliseconds per traced
query: the union of the program's app entry spans (`apps.<app>.<entry>`)
less the part that its module calls (`module.*` spans) and frontier reads
(`apps.host_read`) cover: the loop, the initial state and the glue
between module calls."""
from trace import Intervals


def spans(t, keep) -> Intervals:
    """The union of the slice's spans whose names `keep` accepts."""
    return Intervals((s, e) for name, ss in t.spans.items() if keep(name)
                     for s, e in ss if s >= t.t0 and e <= t.t1)


def overlap(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two unions."""
    tot, i, j = 0.0, 0, 0
    while i < len(a.merged) and j < len(b.merged):
        (s, e), (u, v) = a.merged[i], b.merged[j]
        tot += max(0.0, min(e, v) - max(s, u))
        if e < v:
            i += 1
        else:
            j += 1
    return tot


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    roots = spans(t, lambda n: n.startswith("apps.") and n.count(".") == 2)
    if not roots.merged:
        return None
    inner = spans(t, lambda n: n.startswith("module.")
                  or n == "apps.host_read")
    return (roots.total() - overlap(roots, inner)) * 1e-3 / t.queries
