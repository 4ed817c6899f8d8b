"""Sparse vectors on torch tensors.

Counterpart of `graphlily_tpu/ops/vector.py:20-67`: a fixed-capacity
struct of arrays whose `nnz` is a device scalar, so an app loop reads it
only where the reference reads it (`SpMSpVModule.get_results_nnz`).
`dense_to_sparse` compacts with a cumsum and a scatter, never with
`torch.nonzero` (which reads the count back to the host). The packed
import/export of the reference format (JAX `vector.py:70-87`) is not
ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SparseVector(NamedTuple):
    indices: torch.Tensor   # (capacity,) int32; entries >= nnz are padding
    values: torch.Tensor    # (capacity,)
    nnz: torch.Tensor       # () int32

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]


def sparse_from_entries(indices, values, capacity: int,
                        dtype=torch.float32, device="cpu") -> SparseVector:
    """Build from host entry lists, padded to `capacity` with index 0 and
    value 0."""
    indices = np.asarray(indices, dtype=np.int32)
    n = len(indices)
    if n > capacity:
        raise ValueError(f"{n} entries exceed the capacity {capacity}")
    idx = np.zeros(capacity, np.int32)
    idx[:n] = indices
    val = torch.zeros(capacity, dtype=dtype)
    val[:n] = torch.as_tensor(np.asarray(values), dtype=dtype)
    return SparseVector(torch.from_numpy(idx).to(device), val.to(device),
                        torch.tensor(n, dtype=torch.int32, device=device))


def sparse_to_dense(sv: SparseVector, size: int, zero) -> torch.Tensor:
    """Scatter to a dense (size,) vector, inactive = `zero`; padding
    entries (k >= nnz) are dropped."""
    k = torch.arange(sv.capacity, device=sv.indices.device)
    idx = torch.where(k < sv.nnz, sv.indices.long(), size)
    dense = torch.full((size + 1,), zero, dtype=sv.values.dtype,
                       device=sv.values.device)
    dense.scatter_(0, idx, sv.values)      # slot `size` swallows padding
    return dense[:size]


def compact(m: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Positions of the first `size` True entries of the 1-D bool `m`, in
    ascending order, padded with `fill`: `jnp.nonzero(m, size=size,
    fill_value=fill)[0]` without a host sync. int64."""
    pos = torch.cumsum(m, 0) - 1
    keep = m & (pos < size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=m.device)
    out.scatter_(0, torch.where(keep, pos, size),
                 torch.arange(m.shape[0], device=m.device))
    return out[:size]                      # slot `size` swallows the rest


def dense_to_sparse(dense: torch.Tensor, zero,
                    capacity: int | None = None) -> SparseVector:
    """Compact the entries != `zero`, ascending index, fixed capacity. The
    JAX contract: truncation to the first `capacity` hits,
    nnz = min(count, capacity), padding slots hold index n-1 and
    values = dense[idx]."""
    n = dense.shape[0]
    if capacity is None:
        capacity = n
    m = dense != zero
    nnz = torch.clamp_max(m.sum(), capacity).to(torch.int32)
    idx = compact(m, capacity, n - 1)
    return SparseVector(idx.to(torch.int32), dense[idx], nnz)
