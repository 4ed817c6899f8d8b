"""ops.kernel_calls_per_query: the engines' own `launches` counters over
the whole window, per completed query."""


def read(ctx):
    return ctx.calls / ctx.queries if ctx.queries else None
