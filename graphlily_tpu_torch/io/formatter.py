"""Host-side CSR utilities (numpy): dimension rounding, outdegree
normalization, row and symmetric permutations, the degree-sort relabel,
and the chunked-layout size estimate the engine ladder reads.

The port's copy of the matching functions of `graphlily_tpu/io/formatter.py`.
"""
from __future__ import annotations

import numpy as np

from .matrix import CSRMatrix


def util_round_csr_matrix_dim(csr: CSRMatrix, row_divisor: int,
                              col_divisor: int) -> CSRMatrix:
    """Pad rows/cols up to divisors (in place, returns csr): padded rows
    are empty, padded cols are just a num_cols bump."""
    if csr.num_rows % row_divisor != 0:
        pad = row_divisor - csr.num_rows % row_divisor
        csr.adj_indptr = np.concatenate(
            [csr.adj_indptr,
             np.full(pad, csr.adj_indptr[csr.num_rows], dtype=csr.adj_indptr.dtype)])
        csr.num_rows += pad
    if csr.num_cols % col_divisor != 0:
        csr.num_cols += col_divisor - csr.num_cols % col_divisor
    return csr


def util_normalize_csr_matrix_by_outdegree(csr: CSRMatrix) -> CSRMatrix:
    """Set data[i] = 1 / (#nnz in that column), in place. For a graph
    adjacency with A[dst, src] = edge, the column count is the outdegree."""
    cols = csr.adj_indices[: csr.nnz].astype(np.int64)
    nnz_each_col = np.bincount(cols, minlength=csr.num_cols)
    with np.errstate(divide="ignore"):
        inv = 1.0 / nnz_each_col
    csr.adj_data = inv[cols].astype(csr.adj_data.dtype)
    return csr


def permute_rows(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Return CSR with rows reordered so new row i = old row perm[i]."""
    counts = np.diff(csr.adj_indptr.astype(np.int64))
    new_counts = counts[perm]
    new_indptr = np.zeros(csr.num_rows + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])
    nnz = csr.nnz
    starts = csr.adj_indptr[:-1].astype(np.int64)[perm]
    idx = np.repeat(starts - new_indptr[:-1], new_counts) + np.arange(nnz)
    return CSRMatrix(csr.num_rows, csr.num_cols,
                     csr.adj_data[idx], csr.adj_indices[idx],
                     new_indptr.astype(np.uint32))


def symmetric_permute(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Relabel vertices: new id i = old id perm[i];
    A'[i, j] = A[perm[i], perm[j]]."""
    assert csr.num_rows == csr.num_cols
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    nnz = csr.nnz
    rows = inv[csr.row_ids()]
    cols = inv[csr.adj_indices[:nnz].astype(np.int64)]
    if csr.num_cols <= (1 << 32):
        # one composite-key argsort instead of a lexsort
        order = np.argsort((rows.astype(np.uint64) << 32)
                           | cols.astype(np.uint64), kind="stable")
    else:
        order = np.lexsort((cols, rows))
    indptr = np.zeros(csr.num_rows + 1, np.int64)
    indptr[1:] = np.bincount(rows, minlength=csr.num_rows)
    return CSRMatrix(csr.num_rows, csr.num_cols, csr.adj_data[order],
                     cols[order].astype(np.uint32),
                     np.cumsum(indptr).astype(np.uint32))


def degree_sort_permutation(csr: CSRMatrix) -> np.ndarray:
    """Vertices by descending (in + out) degree."""
    deg = (np.bincount(csr.row_ids(), minlength=csr.num_rows)
           + np.bincount(csr.adj_indices[: csr.nnz].astype(np.int64),
                         minlength=csr.num_rows)[:csr.num_rows])
    return np.argsort(-deg, kind="stable")


def estimate_chunk_layout_gb(csr: CSRMatrix) -> float:
    """Cheap (no-pack) estimate of the chunked layout's device memory, read
    by the engine ladder to decide whether the chunked engine is feasible."""
    work = csr.copy()
    util_round_csr_matrix_dim(work, 1024, 1024)
    nnz = work.nnz
    rows = work.row_ids()
    cols = work.adj_indices[:nnz].astype(np.int64)
    nct = work.num_cols // 1024
    ckey = ((rows // 128) * nct + cols // 1024) * 8 + ((cols % 1024) >> 7)
    uniq, counts = np.unique(ckey, return_counts=True)
    need = (counts + 127) // 128
    guniq, ginv = np.unique(uniq // 8, return_inverse=True)
    gneed = np.zeros(len(guniq), np.int64)
    np.maximum.at(gneed, ginv, need)
    return float(gneed.sum() * 1024 * 12) / 1e9
