"""PageRank, plain: rank = d * A_norm rank + (1 - d) / N, `iterations`
times from rank = 1 / N, where A_norm[v, u] = 1 / out-degree(u) for each
edge u -> v (duplicate edges count apiece) and N is the vertex count
rounded up to `pad_to`, as the app states its teleport term. Written
from that statement alone; it takes the graph and nothing of the
program."""
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
    """One rank vector per query (every query is the same call)."""
    dt = dtype(mode)
    n = graph.num_vertices
    pad = int(traffic["pad_to"])
    big_n = -(-n // pad) * pad
    damping = float(traffic["damping"])
    rows = torch.from_numpy(graph.rows()).to(device)
    cols = torch.from_numpy(graph.indices.astype(np.int64)).to(device)
    outdeg = torch.bincount(cols, minlength=n).to(dt)
    w = operand(damping / outdeg[cols], mode)
    rank = torch.full((n,), 1.0 / big_n, dtype=dt, device=device)
    teleport = (1.0 - damping) / big_n
    for _ in range(int(traffic["iterations"])):
        y = torch.zeros(n, dtype=dt, device=device)
        y.index_add_(0, rows, w * operand(rank[cols], mode))
        rank = y + teleport
    out = rank.cpu().numpy().astype(np.float64)
    return [out for _ in queries]


def compare(got: list, want: list, traffic) -> dict:
    """rank_rel_err: the largest |rank - reference| / reference over every
    vertex of every answer compared (every reference rank is at least the
    teleport term, so none is 0)."""
    err = 0.0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, np.float64)
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            return {"rank_rel_err": float("inf")}
        err = max(err, float(np.max(np.abs(g - w) / w)))
    return {"rank_rel_err": err}
