"""kernels.tropical_walk_roofline: the tropical walk's least time on this
card over its device time per full walk (K4 fused ADDMIN: one tropical
SpMV, a pull step of SSSP), in percent. The least time is the larger of
`bounds.mv_bound`'s bytes over the card's published memory bandwidth and
its operations over its published float32 rate (`peaks.json`, by the
card's name; nothing is read for a card not there), for the graph's
vertices and stored entries, as `kernels.spmv_roofline` reads it. The
device time is that of the operations launched inside the program's
`ops.tropical.fused` spans, the out's zeroing included, over the spans.
The predicated walk (`ops.tropical.fused_pred`) is left out: its bytes
follow the frontier. The walk's row form stores a float32 value and an
int32 word for every element (`ops/router.router_entries`), at least the
8 B an entry that the bound counts, so the reading cannot pass 100%."""
from bounds import mv_bound


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    us, walks = t.under("ops.tropical.fused")
    if not walks or us <= 0:
        return None
    n, nnz = ctx.graph.num_vertices, ctx.graph.nnz
    nbytes, ops = mv_bound(n, n, nnz)
    least_s = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                  ops / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least_s / (us * 1e-6 / walks)
