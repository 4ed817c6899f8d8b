"""Graph500's Kronecker graph (specification section 3; the reference
code's `make_graph`), drawn in torch on the card in a few large calls.

2**scale vertices and edgefactor * 2**scale edges. Each edge picks, at
each of `scale` levels, one quadrant of the adjacency matrix with the
initiator's probabilities a, b, c and d = 1 - a - b - c; the vertex
labels are then permuted at random. The graph is undirected, so each
edge is stored in both directions with one weight, uniform in [0, 1)
(kernel 3's). Duplicate edges and self loops are kept, as the generator
makes them, so every seed gives 2 * edgefactor * 2**scale entries.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from graph import Graph, csr


def make(config: dict, gen: torch.Generator, device: torch.device,
         scale: float | None = None) -> Graph:
    g = config["graph"]
    levels = int(g["scale"])
    if scale is not None:             # the tests' shrink: fewer levels
        levels = max(8, levels + int(math.floor(math.log2(scale))))
    n = 2**levels
    m = int(g["edgefactor"]) * n
    t0, t1, t2 = (int(t * 2**32) for t in
                  np.cumsum([g["a"], g["b"], g["c"]]).astype(np.float64))
    u = torch.zeros(m, dtype=torch.int64, device=device)   # row bits
    v = torch.zeros(m, dtype=torch.int64, device=device)   # column bits
    for _level in range(levels):
        r = torch.randint(0, 2**32, (m,), generator=gen, device=device,
                          dtype=torch.int64)
        ge0, ge1, ge2 = r >= t0, r >= t1, r >= t2
        del r
        u = u * 2 + ge1                    # quadrants c and d: lower half
        v = v * 2 + (ge0 ^ ge1 ^ ge2)      # quadrants b and d: right half
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[u], perm[v]
    w = torch.rand(m, generator=gen, device=device, dtype=torch.float32)
    return csr(n, torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w]))
