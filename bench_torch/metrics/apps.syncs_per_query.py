"""apps.syncs_per_query: host calls that wait for the card (stream,
device or event synchronise, blocking copies) per traced query, not
counting the harness's own wait for each answer."""


def read(ctx):
    t = ctx.trace
    if t is None or t.queries == 0:
        return None
    return t.syncs() / t.queries
