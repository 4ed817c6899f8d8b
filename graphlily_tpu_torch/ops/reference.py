"""Reference engine on torch tensors: COO SpMV, eWiseAdd and dense assign.

Counterpart of the matching functions of `graphlily_tpu/ops/reference.py`.
SpMV here is a gather plus a segment combine over COO arrays; it is the
port's `engine="xla"` fallback and its in-package oracle. These are plain
PyTorch on purpose: in the JAX package they are XLA ops, not kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..semiring import Semiring, MaskType, OpType, apply_mask


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


def spmv_coo(coo: COODevice, x: torch.Tensor, semiring: Semiring,
             mask: torch.Tensor | None = None,
             mask_type: MaskType = MaskType.NO_MASK) -> torch.Tensor:
    """y = mask(A (x) x) over the semiring."""
    contrib = semiring.mul(coo.vals, x[coo.cols])
    if semiring.op == OpType.ADDMIN:
        # padding would contribute mul(0, x[0]) != identity; force it out
        k = torch.arange(coo.rows.shape[0], device=contrib.device)
        contrib = torch.where(k < coo.nnz, contrib,
                              torch.tensor(semiring.zero, dtype=contrib.dtype,
                                           device=contrib.device))
    y = _segment_combine(semiring, contrib, coo.rows, coo.num_rows)
    if mask is not None and mask_type != MaskType.NO_MASK:
        y = apply_mask(y, mask, mask_type, semiring.zero)
    return y


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
