"""Reference engine on torch tensors: COO SpMV and SpMSpV, eWiseAdd, dense
assign and both sparse assigns.

Counterpart of `graphlily_tpu/ops/reference.py`. SpMV and SpMSpV here are
a gather plus a segment combine over COO arrays; they are the port's
`engine="xla"` fallback and its in-package oracle. These are plain
PyTorch on purpose: in the JAX package they are XLA ops, not kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..semiring import (Semiring, MaskType, OpType, apply_mask,
                        apply_mask_sparse_style)
from .vector import SparseVector, sparse_to_dense, dense_to_sparse, compact


@dataclasses.dataclass
class COODevice:
    """Row-sorted COO on a device; padding entries have row = num_rows and
    are dropped by the combine."""

    rows: torch.Tensor   # (nnz_padded,) int64
    cols: torch.Tensor   # (nnz_padded,) int64
    vals: torch.Tensor   # (nnz_padded,)
    num_rows: int
    num_cols: int
    nnz: int


def coo_from_csr(csr, dtype=torch.float32, device="cpu",
                 pad_to_multiple: int = 8) -> COODevice:
    nnz = csr.nnz
    pad = (-nnz) % pad_to_multiple
    rows = np.concatenate([csr.row_ids(), np.full(pad, csr.num_rows, np.int64)])
    cols = np.concatenate([csr.adj_indices[:nnz].astype(np.int64),
                           np.zeros(pad, np.int64)])
    vals = np.concatenate([csr.adj_data[:nnz], np.zeros(pad, csr.adj_data.dtype)])
    return COODevice(torch.as_tensor(rows, device=device),
                     torch.as_tensor(cols, device=device),
                     torch.as_tensor(vals, device=device).to(dtype),
                     csr.num_rows, csr.num_cols, nnz)


def coo_from_csc(csc, dtype=torch.float32, device="cpu",
                 pad_to_multiple: int = 8) -> COODevice:
    """COO from CSC, kept column-major; padding entries have row =
    num_rows."""
    nnz = csc.nnz
    pad = (-nnz) % pad_to_multiple
    cols = np.repeat(np.arange(csc.num_cols, dtype=np.int64),
                     np.diff(csc.adj_indptr.astype(np.int64)))
    rows = np.concatenate([csc.adj_indices[:nnz].astype(np.int64),
                           np.full(pad, csc.num_rows, np.int64)])
    cols = np.concatenate([cols, np.zeros(pad, np.int64)])
    vals = np.concatenate([csc.adj_data[:nnz], np.zeros(pad, csc.adj_data.dtype)])
    return COODevice(torch.as_tensor(rows, device=device),
                     torch.as_tensor(cols, device=device),
                     torch.as_tensor(vals, device=device).to(dtype),
                     csc.num_rows, csc.num_cols, nnz)


def _segment_combine(semiring: Semiring, contrib: torch.Tensor,
                     rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    # one spare row swallows the padding entries
    if semiring.op == OpType.ADDMIN:
        y = torch.full((num_rows + 1,), semiring.zero, dtype=contrib.dtype,
                       device=contrib.device)
        y.scatter_reduce_(0, rows, contrib, "amin", include_self=True)
        return y[:num_rows]
    y = torch.zeros(num_rows + 1, dtype=contrib.dtype, device=contrib.device)
    y.index_add_(0, rows, contrib)
    y = y[:num_rows]
    if semiring.op == OpType.ANDOR:
        y = (y != 0).to(y.dtype)
    return y


def _coo_product(coo: COODevice, x: torch.Tensor,
                 semiring: Semiring) -> torch.Tensor:
    """A (x) x before any mask."""
    contrib = semiring.mul(coo.vals, x[coo.cols])
    if semiring.op == OpType.ADDMIN:
        # padding would contribute mul(0, x[0]) != identity; force it out
        k = torch.arange(coo.rows.shape[0], device=contrib.device)
        contrib = torch.where(k < coo.nnz, contrib, semiring.zero)
    return _segment_combine(semiring, contrib, coo.rows, coo.num_rows)


def spmv_coo(coo: COODevice, x: torch.Tensor, semiring: Semiring,
             mask: torch.Tensor | None = None,
             mask_type: MaskType = MaskType.NO_MASK) -> torch.Tensor:
    """y = mask(A (x) x) over the semiring."""
    y = _coo_product(coo, x, semiring)
    if mask is not None and mask_type != MaskType.NO_MASK:
        y = apply_mask(y, mask, mask_type, semiring.zero)
    return y


def spmspv_coo(coo_csc: COODevice, sv: SparseVector, semiring: Semiring,
               mask: torch.Tensor | None = None,
               mask_type: MaskType = MaskType.NO_MASK,
               capacity: int | None = None
               ) -> tuple[SparseVector, torch.Tensor]:
    """Sparse-vector SpMV: (sparse results, dense results). The frontier is
    scattered to a dense vector filled with the semiring zero, which
    annihilates inactive columns in all three semirings; the mask is the
    SpMSpV flavor (semiring-zero compare and fill)."""
    x = sparse_to_dense(sv, coo_csc.num_cols, semiring.zero)
    y = _coo_product(coo_csc, x, semiring)
    if mask is not None and mask_type != MaskType.NO_MASK:
        y = apply_mask_sparse_style(y, mask, mask_type, semiring.zero)
    cap = capacity or coo_csc.num_rows
    return dense_to_sparse(y, semiring.zero, cap), y


def _scalar(val, like: torch.Tensor) -> float:
    """`val` rounded to the tensor's dtype first, as jnp.asarray does. A
    Python number, not a device tensor: that would cost a host-to-device
    copy on every call of a loop."""
    return torch.tensor(val, dtype=like.dtype).item()


def ewise_add_scalar(x: torch.Tensor, val,
                     length: int | None = None) -> torch.Tensor:
    """out[i] = in[i] + val for i < length, unchanged beyond (a plain add
    whatever the semiring; with val = 0 it is the vector copy).
    `length=None` means the whole vector."""
    y = x + _scalar(val, x)
    if length is None:
        return y
    keep = torch.arange(x.shape[0], device=x.device) < length
    return torch.where(keep, y, x)


def assign_vector_dense(inout: torch.Tensor, mask: torch.Tensor, val,
                        mask_type: MaskType) -> torch.Tensor:
    """Masked dense assign: WRITE_TO_ZERO sets val where mask == 0,
    WRITE_TO_ONE where mask != 0."""
    v = _scalar(val, inout)
    if mask_type == MaskType.WRITE_TO_ZERO:
        return torch.where(mask == 0, v, inout)
    if mask_type == MaskType.WRITE_TO_ONE:
        return torch.where(mask != 0, v, inout)
    raise ValueError("assign_vector_dense requires a mask type")


def _drop_padding(sv: SparseVector, size: int) -> torch.Tensor:
    """The entries' indices, int64, with padding (k >= nnz) sent to
    `size`."""
    k = torch.arange(sv.capacity, device=sv.indices.device)
    return torch.where(k < sv.nnz, sv.indices.long(), size)


def assign_vector_sparse_no_new_frontier(inout: torch.Tensor,
                                         mask: SparseVector,
                                         val) -> torch.Tensor:
    """inout[mask.indices[k]] = val for k < mask.nnz."""
    n = inout.shape[0]
    out = torch.cat([inout, inout.new_zeros(1)])
    out.index_fill_(0, _drop_padding(mask, n), _scalar(val, inout))
    return out[:n]


def assign_vector_sparse_new_frontier(inout: torch.Tensor,
                                      mask: SparseVector,
                                      capacity: int | None = None
                                      ) -> tuple[torch.Tensor, SparseVector]:
    """Relaxation with frontier generation: where inout[idx] > val, set
    inout[idx] = val, and (idx, val) joins the new frontier (ascending
    position order; nnz is the improved count, not clamped, as in the JAX
    function). Mask indices are unique (SpMSpV results)."""
    n = inout.shape[0]
    cap = capacity or mask.capacity
    idx = _drop_padding(mask, n)
    cur = torch.cat([inout, inout.new_zeros(1)])[idx]
    improved = (idx < n) & (cur > mask.values)
    out = torch.cat([inout, inout.new_zeros(1)])
    out.scatter_reduce_(0, torch.where(improved, idx, n), mask.values,
                        "amin", include_self=True)
    nnz = improved.sum().to(torch.int32)
    pos = compact(improved, cap, mask.capacity - 1)
    return out[:n], SparseVector(mask.indices[pos], mask.values[pos], nnz)
