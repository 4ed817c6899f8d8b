"""Spans at the port's layer boundaries, on the profiler's own clock.

`span(name)` is `torch.profiler.record_function(name)` while a torch
profiler records, so the spans share the device trace's timeline; else
it is one shared context that does nothing. The profiler being on is the
only switch. Spans nest on the host: a query's spans are those inside
its app span. The layout analysis (`analyze_layout`) is not ported
yet (ROADMAP queue 1, item 10).

  apps.<app>.<entry>   a public entry of PageRank, SSSP or BFS: a query
  apps.init            the initial state
  apps.push_step       one push iteration: SpMSpV, its glue, its nnz read
  apps.pull_step       one pull iteration: SpMV and its glue
  apps.host_read       pull_push's frontier-nnz read: the host waits
  module.spmv          SpMVModule.apply
  module.spmspv        SpMSpVModule.apply_dense and apply
  ops.<engine>.<key>   one kernel launch, counted in the engine's
                       `launches[key]` (ops/_build.Launches); SSSP's relax
                       kernel as `ops.sssp.relax`, in `SSSP.launches`
  tropical.activity    the tropical engine's SpMSpV tile activity (torch
                       ops, no launch counted)
  tropical.decode      its decode and mask after each walk (the same)
  router.activity      the roll and planar engines' SpMSpV activity
                       flags (torch ops, no launch counted)
  router.epilogue      their ANDOR 0/1 clamp and SpMV mask after a call,
                       where either runs (the same)
  bfs.assign           BFS's level stamp and its push step's frontier
                       count, before the count's read (the same)
"""
from __future__ import annotations

from torch.autograd import _profiler_enabled
from torch.profiler import record_function


class _Off:
    """The span while no profiler records. Entering and leaving it call
    `"".format`, a C function that takes any arguments and returns "",
    which is false, so an exception passes through and no Python frame
    runs: a span costs the gate and the `with`, 0.31-0.38 us on an H100
    machine's host against 0.50-0.61 us with Python methods."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


OFF = _Off()


def span(name: str):
    """A `record_function` span named `name` while a profiler records,
    else `OFF`."""
    if _profiler_enabled():
        return record_function(name)
    return OFF
