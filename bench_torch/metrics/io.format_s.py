"""io.format_s: host seconds of `load_and_format_matrix` and
`send_matrix_host_to_device` in set-up (the engines' `init_seconds`, the
device forms derived at init, are inside it and printed beside it)."""


def read(ctx):
    return ctx.format_s if ctx.cuda else None
