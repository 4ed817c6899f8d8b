"""kernels.bfs_walk_roofline: the ANDOR walk's least time on this card
over its device time per full walk (K4 fused ANDOR: one masked pull step
of BFS), in percent. The least time is `bounds_logical.logical_mv_bytes`
for the graph's vertices and stored entries over the card's published
memory bandwidth (`peaks.json`, by the card's name; nothing is read for a
card not there); a boolean AND and OR an entry take far less at its
float32 rate. The device time is that of the operations launched inside
the program's `ops.planar.fused` spans, the output's zeroing included,
over the spans. The predicated walk (`ops.planar.fused_pred`) is left
out: its bytes follow the frontier. The walk's row form without values
(`ops/router.router_entries(values=None)`) stores a 4 B word for every
stored entry and a 16 B record for every segment and block; the walk
writes the whole of y (its zeroing) and reads x only where an entry
needs it. So its bytes fall short of the bound's only by the row
pointers (4 B a row, which the form does not hold) and the x of the
vertices with no entry (4 B each): 3.8% of the bound on
`graph500-s19-k2`, where 36% of the vertices have no entry. The reading
can pass 100% only where the walk moves its bytes at over 96% of the
published peak. `kernels.spmv_roofline`'s 8 B an entry would misread
this form."""
from bounds_logical import logical_mv_bytes


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    us, walks = t.under("ops.planar.fused")
    if not walks or us <= 0:
        return None
    n, nnz = ctx.graph.num_vertices, ctx.graph.nnz
    least_s = logical_mv_bytes(n, n, nnz) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (us * 1e-6 / walks)
