"""module.spmspv_device_ms: device milliseconds per traced query of the
operations launched inside `SpMSpVModule.apply_dense` (push steps)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    us, spans = t.under("SpMSpVModule.apply_dense")
    return us * 1e-3 / t.queries if spans else None
