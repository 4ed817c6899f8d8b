"""Host-side CSR utilities (numpy): dimension rounding, outdegree
normalization, row and symmetric permutations, the degree-sort relabel,
SSSP's self edges, the chunked layout (`pack_csr_chunks`) and its size
estimate, which the engine ladder reads.

The port's copy of the matching functions of `graphlily_tpu/io/formatter.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .matrix import CSRMatrix

W = 128     # row window: rows of one chunk's output window
S = 8       # chunk sublanes
L = 128     # lanes
C = 1024    # column tile: x elements one chunk gathers from
CB = 32     # chunks per step of the JAX resident kernel (step_touch rows)


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


def _sort_order(keys: list[np.ndarray], widths: list[int]) -> np.ndarray:
    """`np.lexsort(keys[::-1])` (the first key most significant) as one
    stable argsort of a composite int64 key when the key widths fit in 63
    bits; the composite sort is an order of magnitude faster."""
    bits = sum(max(int(w) - 1, 0).bit_length() for w in widths)
    if bits > 63:
        return np.lexsort(keys[::-1])
    key = np.zeros(len(keys[0]), np.int64)
    for k, w in zip(keys, widths):
        key = key * int(w) + k
    return np.argsort(key, kind="stable")


def add_self_edges_for_sssp(csr: CSRMatrix) -> CSRMatrix:
    """Insert zero-weight self edges and zero the existing diagonal, so
    distances stay monotone under relaxation (the reference's SSSP
    preprocessing, graphlily/app/sssp.h:16-62)."""
    n = min(csr.num_rows, csr.num_cols)
    nnz = csr.nnz
    rows = csr.row_ids()
    cols = csr.adj_indices[:nnz].astype(np.int64)
    data = csr.adj_data[:nnz].astype(np.float32).copy()
    diag = rows == cols
    data[diag] = 0.0
    have_diag = np.zeros(csr.num_rows, dtype=bool)
    have_diag[rows[diag]] = True
    missing = np.nonzero(~have_diag[:n])[0]
    all_rows = np.concatenate([rows, missing])
    all_cols = np.concatenate([cols, missing])
    all_data = np.concatenate([data, np.zeros(len(missing), np.float32)])
    order = _sort_order([all_rows, all_cols], [csr.num_rows, csr.num_cols])
    all_rows, all_cols, all_data = (all_rows[order], all_cols[order],
                                    all_data[order])
    indptr = np.zeros(csr.num_rows + 1, dtype=np.int64)
    indptr[1:] = np.bincount(all_rows, minlength=csr.num_rows)
    indptr = np.cumsum(indptr)
    return CSRMatrix(csr.num_rows, csr.num_cols, all_data,
                     all_cols.astype(np.uint32), indptr.astype(np.uint32))


@dataclasses.dataclass
class ChunkedSpMVLayout:
    """The chunked layout of `graphlily_tpu/io/formatter.py`, array for
    array. NC chunks of (S, L) = (8, 128) slots:

      r      (NC, S, L) int8   x lane, col & 127; sublane s holds only
                               columns of bucket s of the chunk's tile
      rows   (NC, S, L) int8   row - window base (0..127)
      vals   (NC, S, L)        values; padding slots hold `pad_val`
      code   (NC,)      int32  (window_group*8 + window_sub)*nct + col_tile
      inv    (NC, S, W) int8   tropical layouts only: last lane of each
                               row's run in (chunk, sublane), -1 if absent
                               (the TPU kernel's segmented-scan gather; the
                               CUDA kernel does not read it)
      step_touch (NC/32, nct)  chunk_order="col" only: which column tiles
                               each 32-chunk step touches (SpMSpV)
      el_slot (nnz,) int64     original nnz -> flat vals slot

    Lanes of one (chunk, sublane) are filled from lane 0 in row order, so
    each row's slots form one contiguous run.
    """

    r: np.ndarray
    rows: np.ndarray
    vals: np.ndarray
    code: np.ndarray
    num_rows: int          # padded
    num_cols: int          # padded
    nnz: int
    num_col_tiles: int
    num_window_groups: int
    row_window: int
    col_tile: int
    fill: float            # nnz / slots
    inv: Optional[np.ndarray] = None
    step_touch: Optional[np.ndarray] = None
    el_slot: Optional[np.ndarray] = None

    @property
    def num_chunks(self) -> int:
        return self.r.shape[0]


def _assign_chunks(wid, cid, sub, nct):
    """Chunk and lane of every nnz, given nnz sorted by (wid, cid, sub,
    row, col): a (window, tile) group takes as many chunks as its fullest
    sublane class needs; a class fills lanes in order. Returns (chunk_id,
    lane, nchunk)."""
    nnz = len(wid)
    if nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 1
    ckey = (wid * nct + cid) * S + sub                 # sorted
    cstart = np.flatnonzero(np.r_[True, ckey[1:] != ckey[:-1]])
    ccount = np.diff(np.r_[cstart, nnz])
    rank = np.arange(nnz, dtype=np.int64) - np.repeat(cstart, ccount)
    cgrp = ckey[cstart] // S                           # sorted
    gfirst = np.flatnonzero(np.r_[True, cgrp[1:] != cgrp[:-1]])
    gneed = np.maximum.reduceat((ccount + L - 1) // L, gfirst)
    goff = np.concatenate([[0], np.cumsum(gneed)])
    cls_group = np.repeat(np.arange(len(gfirst)),
                          np.diff(np.r_[gfirst, len(cgrp)]))
    chunk_id = goff[np.repeat(cls_group, ccount)] + rank // L
    return chunk_id, rank % L, max(int(goff[-1]), 1)


def _reorder_chunks(order, arrays, el_slot):
    """Chunks in `order`; el_slot follows its slots."""
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    el_slot = inv[el_slot // (S * L)] * (S * L) + el_slot % (S * L)
    return [None if a is None else a[order] for a in arrays], el_slot


def pack_csr_chunks(csr: CSRMatrix, pad_val: float = 0.0,
                    chunk_order: str = "row") -> ChunkedSpMVLayout:
    """Pack a CSR matrix into the chunked layout; array-equal to the JAX
    package's `pack_csr_chunks` (its numpy path, which its native packer
    equals).

    `pad_val` must be the semiring zero (0, or FLOAT_INF for tropical), so
    padding slots add the semiring identity; a nonzero `pad_val` also
    builds `inv`. `chunk_order="row"` orders chunks by code, "col" by
    (col tile, code) and builds `step_touch`. Rows are padded to a
    multiple of 1024 and columns of 1024; every 1024-row window group gets
    at least one chunk (all-padding fillers), and the chunk count is
    padded to a multiple of 64 with padding chunks that repeat the last
    code. The geometry is fixed and the values are float32.
    """
    work = csr.copy()
    util_round_csr_matrix_dim(work, 8 * W, C)
    nrows, ncols = work.num_rows, work.num_cols
    nnz = work.nnz
    nct = ncols // C

    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:nnz].astype(np.int64)
    vv = work.adj_data[:nnz]
    wid, cid, sub = rr // W, cc // C, (cc % C) >> 7
    # lanes of a (window, tile, sublane) class in row order: row runs are
    # contiguous (the tropical scan needs it; the add semirings ignore it)
    order = _sort_order([wid, cid, sub, rr % W, cc % L],
                        [nrows // W, nct, S, W, L])
    rr, cc, vv, wid, cid, sub = (a[order]
                                 for a in (rr, cc, vv, wid, cid, sub))
    chunk_id, lane, nchunk = _assign_chunks(wid, cid, sub, nct)

    r = np.zeros((nchunk, S, L), np.int8)
    rows_arr = np.zeros((nchunk, S, L), np.int8)
    vals = np.full((nchunk, S, L), pad_val, dtype=np.float32)
    r[chunk_id, sub, lane] = (cc & 127).astype(np.int8)
    rows_arr[chunk_id, sub, lane] = (rr % W).astype(np.int8)
    vals[chunk_id, sub, lane] = vv
    el_slot = np.empty(nnz, np.int64)
    el_slot[order] = chunk_id * (S * L) + sub * L + lane

    with_inv = pad_val != 0.0
    inv = None
    if with_inv:
        # a row's run ends at the last of its equal keys in sorted order
        inv = np.full((nchunk, S, W), -1, np.int8)
        key = (chunk_id * S + sub) * W + rr % W
        last = np.r_[key[1:] != key[:-1], True] if nnz else np.zeros(0, bool)
        inv.reshape(-1)[key[last]] = lane[last].astype(np.int8)

    cwid = np.zeros(nchunk, np.int64)
    ccid = np.zeros(nchunk, np.int64)
    cwid[chunk_id] = wid
    ccid[chunk_id] = cid
    code = cwid * nct + ccid

    # every window group gets a chunk: all-padding fillers for empty ones
    nwgrp = nrows // (8 * W)
    present = np.zeros(nwgrp, bool)
    present[code // (S * nct)] = True
    missing = np.nonzero(~present)[0]
    if len(missing):
        nm = len(missing)
        r = np.concatenate([r, np.zeros((nm, S, L), np.int8)])
        rows_arr = np.concatenate([rows_arr, np.zeros((nm, S, L), np.int8)])
        vals = np.concatenate([vals, np.full((nm, S, L), pad_val, np.float32)])
        code = np.concatenate([code, missing * (S * nct)])
        if with_inv:
            inv = np.concatenate([inv, np.full((nm, S, W), -1, np.int8)])
        (r, rows_arr, vals, code, inv), el_slot = _reorder_chunks(
            np.argsort(code, kind="stable"), [r, rows_arr, vals, code, inv],
            el_slot)
        nchunk += nm

    if chunk_order == "col":
        (r, rows_arr, vals, code, inv), el_slot = _reorder_chunks(
            np.lexsort((code, code % nct)), [r, rows_arr, vals, code, inv],
            el_slot)

    # chunk count to a multiple of 64 (the JAX resident kernel's batch)
    padn = (-nchunk) % 64
    if padn:
        r = np.concatenate([r, np.zeros((padn, S, L), np.int8)])
        rows_arr = np.concatenate([rows_arr, np.zeros((padn, S, L), np.int8)])
        vals = np.concatenate([vals, np.full((padn, S, L), pad_val, np.float32)])
        code = np.concatenate([code, np.full(padn, code[-1], code.dtype)])
        if with_inv:
            inv = np.concatenate([inv, np.full((padn, S, W), -1, np.int8)])
        nchunk += padn

    code = code.astype(np.int32)
    step_touch = None
    if chunk_order == "col":
        step_touch = np.zeros((nchunk // CB, nct), np.float32)
        step_touch[np.arange(nchunk) // CB, code % nct] = 1.0
    return ChunkedSpMVLayout(
        r=r, rows=rows_arr, vals=vals, code=code,
        num_rows=nrows, num_cols=ncols, nnz=nnz,
        num_col_tiles=nct, num_window_groups=nwgrp,
        row_window=W, col_tile=C, fill=nnz / (nchunk * S * L),
        inv=inv, step_touch=step_touch, el_slot=el_slot)


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
