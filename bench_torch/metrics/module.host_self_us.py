"""module.host_self_us: host microseconds per module call (the program's
`module.spmv` and `module.spmspv` spans) that its kernel launches
(`ops.*` spans) do not cover: the module's dispatch, the engine's
argument checks, activity and live sets, and the epilogue."""
from trace import Intervals


def spans(t, prefix: str) -> list:
    return [(s, e) for name, ss in t.spans.items() if name.startswith(prefix)
            for s, e in ss if s >= t.t0 and e <= t.t1]


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
    if t is None:
        return None
    calls = spans(t, "module.")
    if not calls:
        return None
    own = Intervals(calls)
    return (own.total() - overlap(own, Intervals(spans(t, "ops.")))) / len(
        calls)
