"""device.launches_per_query: kernels that ran on the card per traced
query, the program's torch glue included."""


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0 or not t.gpu:
        return None
    return len(t.kernels()) / t.queries
