"""Sparse matrix containers and loaders (numpy, host side).

The port's own copy of `graphlily_tpu/io/matrix.py`: the JAX package's
`io` pulls in jax through its package `__init__`, and the port must run
where jax is not installed. The tests hold the two copies equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row."""

    num_rows: int
    num_cols: int
    adj_data: np.ndarray     # (nnz,)
    adj_indices: np.ndarray  # (nnz,) column index per nnz
    adj_indptr: np.ndarray   # (num_rows+1,)

    @property
    def nnz(self) -> int:
        return int(self.adj_indptr[-1])

    def copy(self) -> "CSRMatrix":
        return CSRMatrix(self.num_rows, self.num_cols, self.adj_data.copy(),
                         self.adj_indices.copy(), self.adj_indptr.copy())

    def row_ids(self) -> np.ndarray:
        """Expand indptr to a per-nnz row-id array (COO rows)."""
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int64),
            np.diff(self.adj_indptr.astype(np.int64)),
        )


@dataclasses.dataclass
class CSCMatrix:
    """Compressed sparse column."""

    num_rows: int
    num_cols: int
    adj_data: np.ndarray
    adj_indices: np.ndarray  # row index per nnz
    adj_indptr: np.ndarray   # (num_cols+1,)

    @property
    def nnz(self) -> int:
        return int(self.adj_indptr[-1])


def csr_from_coo(rows, cols, vals, num_rows, num_cols) -> CSRMatrix:
    """Build CSR from COO triplets (sorted stably by row)."""
    rows = np.asarray(rows)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
    indptr = np.zeros(num_rows + 1, dtype=np.uint32)
    counts = np.bincount(rows, minlength=num_rows)
    indptr[1:] = np.cumsum(counts, dtype=np.uint64).astype(np.uint32)
    return CSRMatrix(num_rows, num_cols, vals, cols.astype(np.uint32), indptr)


def load_csr_matrix_from_float_npz(path) -> CSRMatrix:
    """Load a scipy-saved CSR npz as float32."""
    f = np.load(path, allow_pickle=False)
    data = f["data"].astype(np.float32)
    indices = f["indices"].astype(np.uint32)
    indptr = f["indptr"].astype(np.uint32)
    shape = f["shape"]
    num_rows, num_cols = int(shape[0]), int(shape[-1])
    return CSRMatrix(num_rows, num_cols, data, indices, indptr)


def csr2csc(csr: CSRMatrix) -> CSCMatrix:
    """Transpose storage order by a stable counting sort over columns."""
    nnz = csr.nnz
    cols = csr.adj_indices[:nnz].astype(np.int64)
    rows = csr.row_ids()[:nnz]
    indptr = np.zeros(csr.num_cols + 1, dtype=np.int64)
    indptr[1:] = np.bincount(cols, minlength=csr.num_cols)
    indptr = np.cumsum(indptr)
    order = np.argsort(cols, kind="stable")
    return CSCMatrix(
        num_rows=csr.num_rows,
        num_cols=csr.num_cols,
        adj_data=csr.adj_data[:nnz][order].copy(),
        adj_indices=rows[order].astype(np.uint32),
        adj_indptr=indptr.astype(np.uint32),
    )


def csc2csr(csc: CSCMatrix) -> CSRMatrix:
    """Inverse of csr2csc, by a stable sort over rows."""
    nnz = csc.nnz
    rows = csc.adj_indices[:nnz].astype(np.int64)
    cols = np.repeat(np.arange(csc.num_cols, dtype=np.int64),
                     np.diff(csc.adj_indptr.astype(np.int64)))
    indptr = np.zeros(csc.num_rows + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows, minlength=csc.num_rows)
    indptr = np.cumsum(indptr)
    order = np.argsort(rows, kind="stable")
    return CSRMatrix(
        num_rows=csc.num_rows,
        num_cols=csc.num_cols,
        adj_data=csc.adj_data[:nnz][order].copy(),
        adj_indices=cols[order].astype(np.uint32),
        adj_indptr=indptr.astype(np.uint32),
    )
