"""Single-source shortest paths within `iterations` hops, plain: from
d = 0 at the source and infinity elsewhere, `iterations` rounds of
d[v] = min(d[v], min over edges u -> v of d[u] + w(u, v)), the hop limit
that pull, push and pull_push of the app state alike. Written from that
statement alone; it takes the graph and nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

from precision import dtype, operand

# the modes whose answers must fail the cell's limits, and those that must
# be within them (`control.py`)
CONTROLS = ("tf32",)
SOUND = ("float32",)


def solve(graph, config, traffic, queries, mode: str,
          device: torch.device) -> list:
    """One distance vector per query (a source vertex id); unreached
    vertices hold infinity."""
    dt = dtype(mode)
    n = graph.num_vertices
    rows = torch.from_numpy(graph.rows()).to(device)
    cols = torch.from_numpy(graph.indices.astype(np.int64)).to(device)
    w = operand(torch.from_numpy(graph.weights).to(device, dt), mode)
    out = []
    for source in queries:
        d = torch.full((n,), float("inf"), dtype=dt, device=device)
        d[int(source)] = 0.0
        for _ in range(int(config["iterations"]["sssp"])):
            d = d.scatter_reduce(0, rows, operand(d[cols], mode) + w, "amin",
                                 include_self=True)
        out.append(d.cpu().numpy().astype(np.float64))
    return out


def compare(got: list, want: list, traffic) -> dict:
    """reach_mismatch: vertices reached on one side only (the program's
    unreached value is `traffic["infinity"]`); dist_rel_err: the largest
    |d - reference| / reference over vertices reached on both sides (a
    reference distance of 0 must be met exactly)."""
    unreached = float(traffic["infinity"])
    mismatch, err = 0, 0.0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, np.float64)
        if g.shape != w.shape or np.any(np.isnan(g)):
            return {"reach_mismatch": float(len(w)), "dist_rel_err": float("inf")}
        g_reach = g < unreached
        w_reach = np.isfinite(w)
        mismatch += int(np.count_nonzero(g_reach != w_reach))
        both = g_reach & w_reach
        gd, wd = g[both], w[both]
        zero = wd == 0
        if np.any(gd[zero] != 0):
            err = float("inf")
        pos = ~zero
        if np.any(pos):
            err = max(err, float(np.max(np.abs(gd[pos] - wd[pos]) / wd[pos])))
    return {"reach_mismatch": float(mismatch), "dist_rel_err": err}
