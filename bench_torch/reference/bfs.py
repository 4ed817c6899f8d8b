"""Breadth-first search levels within `iterations` hops, plain: 1 at the
source, h + 1 at each vertex first reached at hop h, 0 where none is
reached within the hop limit, which pull, push and pull_push of the app
state alike. A vertex is reached at hop h where an edge u -> v leads to
it from a vertex u first reached at hop h - 1 (the source at hop 0).
Written from that statement alone; it takes the graph and nothing of the
program."""
from __future__ import annotations

import numpy as np
import torch

# the modes whose answers must fail the cell's limits, and those that must
# be within them (`control.py`)
CONTROLS = ("short",)
SOUND = ("float32",)
MODES = ("float64", "float32", "short")


def levels(rows: torch.Tensor, cols: torch.Tensor, n: int, source: int,
           hops: int, dt: torch.dtype) -> torch.Tensor:
    """The level vector from `source` after `hops` hops, in `dt`; an entry
    (rows[i], cols[i]) is an edge from cols[i] to rows[i]."""
    d = torch.zeros(n, dtype=dt, device=rows.device)
    d[source] = 1
    frontier = d != 0
    for hop in range(1, hops + 1):
        hit = torch.zeros(n, dtype=torch.bool, device=rows.device)
        hit[rows[frontier[cols]]] = True
        frontier = hit & (d == 0)
        d[frontier] = hop + 1
    return d


def solve(graph, config, traffic, queries, mode: str,
          device: torch.device) -> list:
    """One level vector per query (a source vertex id). "float32" keeps
    the levels in float32; "short" stops one hop short of the deepest
    level that the full search reaches, the least early exit that changes
    the answer."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dt = torch.float32 if mode == "float32" else torch.float64
    n = graph.num_vertices
    rows = torch.from_numpy(graph.rows()).to(device)
    cols = torch.from_numpy(graph.indices.astype(np.int64)).to(device)
    hops = int(config["iterations"]["bfs"])
    out = []
    for source in queries:
        d = levels(rows, cols, n, int(source), hops, dt)
        if mode == "short":
            # the deepest level L is reached at hop L - 1
            d = levels(rows, cols, n, int(source), int(d.max()) - 2, dt)
        out.append(d.cpu().numpy().astype(np.float64))
    return out


def compare(got: list, want: list, traffic) -> dict:
    """level_mismatch: the vertices whose level differs from the
    reference's, over every answer (an answer of another length counts
    every vertex)."""
    mismatch = 0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, np.float64)
        if g.shape != w.shape:
            mismatch += len(w)
            continue
        mismatch += int(np.count_nonzero(g != w))
    return {"level_mismatch": float(mismatch)}
