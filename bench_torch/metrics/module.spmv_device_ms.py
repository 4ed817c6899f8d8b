"""module.spmv_device_ms: device milliseconds per traced query of the
operations launched inside `SpMVModule.apply`."""


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    us, spans = t.under("SpMVModule.apply")
    return us * 1e-3 / t.queries if spans else None
