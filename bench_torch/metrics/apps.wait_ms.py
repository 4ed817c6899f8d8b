"""apps.wait_ms: host milliseconds per traced query inside the program's
`apps.host_read` spans: pull_push's frontier-nnz reads, where the host
waits for the card in the middle of a query."""
from trace import Intervals


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    reads = [(s, e) for s, e in t.spans.get("apps.host_read", [])
             if s >= t.t0 and e <= t.t1]
    return Intervals(reads).total() * 1e-3 / t.queries if reads else None
