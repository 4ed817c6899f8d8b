"""kernels.spmv_roofline: the SpMV's least time on this card over its
device time per `SpMVModule.apply` call, in percent. The least time is the
larger of `bounds.mv_bound`'s bytes over the card's published memory
bandwidth and its operations over its published float32 rate
(`peaks.json`, by the card's name; nothing is read for a card not
there)."""
from bounds import mv_bound


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    us, spans = t.under("SpMVModule.apply")
    if not spans or us <= 0:
        return None
    n, nnz = ctx.graph.num_vertices, ctx.graph.nnz
    nbytes, ops = mv_bound(n, n, nnz)
    least_s = max(nbytes / ctx.peaks["hbm_bytes_per_s"],
                  ops / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least_s / (us * 1e-6 / spans)
