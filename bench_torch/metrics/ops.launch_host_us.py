"""ops.launch_host_us: the mean host microseconds of one kernel launch,
the program's `ops.<engine>.<key>` spans: the output allocation, the
ctypes call and its return-code check."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = [e - s for name, ss in t.spans.items() if name.startswith("ops.")
          for s, e in ss if s >= t.t0 and e <= t.t1]
    return sum(us) / len(us) if us else None
