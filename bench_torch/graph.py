"""The graph a cell runs on, and its query sources.

A configuration's `graph.generator` names the module
`graphs/<generator>.py` that draws it: `make(config, gen, device, scale)`
returns a `Graph` from the `torch.Generator` `gen` on `device` (one seed
gives one graph on that kind of device); `scale`, given by the tests
only, shrinks it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """A graph in CSR on the host: entry (row, col, weight) is an edge
    from vertex `col` to vertex `row`, as the apps read A (x = per
    column, y = per row). `indices` and `indptr` are uint32, `weights`
    float32, as a graph file loaded by a user would give them."""

    num_vertices: int
    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_vertices, dtype=np.int64),
                         np.diff(self.indptr.astype(np.int64)))


def csr(num_vertices: int, rows: torch.Tensor, cols: torch.Tensor,
        weights: torch.Tensor) -> Graph:
    """The entries (rows[i], cols[i], weights[i]), sorted stably by row
    into CSR on their device, then brought to the host."""
    order = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=num_vertices)
    indptr = torch.zeros(num_vertices + 1, dtype=torch.int64,
                         device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Graph(
        num_vertices,
        indptr.cpu().numpy().astype(np.uint32),
        cols[order].to(torch.int32).cpu().numpy().view(np.uint32),
        weights[order].cpu().numpy())


def out_degree_sources(graph: Graph, count: int,
                       gen: torch.Generator) -> np.ndarray:
    """`count` query sources drawn uniformly, with replacement, among the
    vertices with at least one out-edge that is not a self loop
    (Graph500's rule for search keys), in the graph's own vertex ids."""
    cols = graph.indices.astype(np.int64)
    deg = np.bincount(cols[cols != graph.rows()],
                      minlength=graph.num_vertices)
    live = torch.from_numpy(np.nonzero(deg)[0])
    pick = torch.randint(0, len(live), (count,), generator=gen,
                         device=gen.device)
    return live[pick.cpu()].numpy()


def make(config: dict, gen: torch.Generator, device: torch.device,
         scale: float | None = None) -> Graph:
    """The configuration's graph, drawn by the module its
    `graph.generator` names."""
    import spec
    mod = spec.load_module(spec.BENCH_DIR / "graphs"
                           / f"{config['graph']['generator']}.py")
    return mod.make(config, gen, device, scale)
