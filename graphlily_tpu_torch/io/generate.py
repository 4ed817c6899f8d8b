"""Synthetic graph generators (numpy, host side).

The port's copy of `graphlily_tpu/io/generate.py`: for the same seed it
draws the same numbers in the same order, so both packages build the same
graphs. The ICCAD'21 evaluation graphs are stood in for by RMAT graphs of
matching vertex and edge counts.
"""
from __future__ import annotations

import numpy as np

from .matrix import CSRMatrix, csr_from_coo


def uniform_csr(num_rows: int, num_cols: int, degree: int, seed: int = 0,
                dtype=np.float32) -> CSRMatrix:
    """Each row gets `degree` uniformly random columns (with replacement)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), degree)
    cols = rng.integers(0, num_cols, size=num_rows * degree, dtype=np.int64)
    vals = rng.random(num_rows * degree).astype(dtype)
    return csr_from_coo(rows, cols, vals, num_rows, num_cols)


def dense_csr(num_rows: int, num_cols: int, val: float = 1.0,
              dtype=np.float32) -> CSRMatrix:
    """Fully dense matrix in CSR form."""
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), num_cols)
    cols = np.tile(np.arange(num_cols, dtype=np.int64), num_rows)
    vals = np.full(num_rows * num_cols, val, dtype=dtype)
    return csr_from_coo(rows, cols, vals, num_rows, num_cols)


def conflict_csr(num_rows: int, num_cols: int, dtype=np.float32) -> CSRMatrix:
    """Adversarial matrix: all nnz columns collide mod 128."""
    deg = max(1, num_cols // 128)
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), deg)
    cols = (np.tile(np.arange(deg, dtype=np.int64), num_rows) * 128) % num_cols
    vals = np.ones(num_rows * deg, dtype=dtype)
    return csr_from_coo(rows, cols, vals, num_rows, num_cols)


def rmat_csr(num_rows: int, nnz: int, seed: int = 0,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             dtype=np.float32) -> CSRMatrix:
    """RMAT/Kronecker power-law graph (Graph500 parameters by default):
    each of log2(N) levels picks a quadrant per edge with probabilities
    (a, b, c, d)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_rows, 2))))
    rows = np.zeros(nnz, dtype=np.int32)
    cols = np.zeros(nnz, dtype=np.int32)
    u = np.empty(nnz, dtype=np.uint32)
    bit = np.empty(nnz, dtype=np.int32)
    tmp = np.empty(nnz, dtype=bool)
    t0, t1, t2 = (int(t * 2**32) for t in
                  np.cumsum([a, b, c]).astype(np.float64))
    for _level in range(scale):
        u[:] = rng.integers(0, 2**32, size=nnz, dtype=np.uint32)
        # quad = #thresholds passed; row bit = (u >= t1),
        # col bit = (u >= t0) ^ (u >= t1) ^ (u >= t2)
        np.left_shift(rows, 1, out=rows)
        np.greater_equal(u, t1, out=tmp)
        np.add(rows, tmp, out=rows, casting="unsafe")
        np.left_shift(cols, 1, out=cols)
        np.greater_equal(u, t0, out=tmp)
        bit[:] = tmp
        np.greater_equal(u, t1, out=tmp)
        np.bitwise_xor(bit, tmp, out=bit, casting="unsafe")
        np.greater_equal(u, t2, out=tmp)
        np.bitwise_xor(bit, tmp, out=bit, casting="unsafe")
        np.add(cols, bit, out=cols)
    np.mod(rows, num_rows, out=rows)
    np.mod(cols, num_rows, out=cols)
    vals = rng.random(nnz, dtype=np.float32).astype(dtype, copy=False)
    return csr_from_coo(rows, cols, vals, num_rows, num_rows)


# ICCAD'21 evaluation graph stand-ins: (num_rows, nnz, bfs iterations)
ICCAD_GRAPHS = {
    "googleplus": dict(num_rows=107_614, nnz=13_673_453, iters=7),
    "ogbl_ppa": dict(num_rows=576_289, nnz=42_463_862, iters=11),
    "hollywood": dict(num_rows=1_139_905, nnz=112_751_422, iters=10),
    "pokec": dict(num_rows=1_632_803, nnz=30_622_564, iters=11),
    "ogbn_products": dict(num_rows=2_449_029, nnz=123_718_280, iters=23),
    "orkut": dict(num_rows=3_072_441, nnz=234_370_166, iters=6),
}


def iccad_standin(name: str, scale: float = 1.0, seed: int = 0) -> CSRMatrix:
    """RMAT stand-in for one of the six evaluation graphs; `scale` shrinks
    both dimensions and nnz for quick runs."""
    info = ICCAD_GRAPHS[name]
    n = max(1024, int(info["num_rows"] * scale))
    m = max(4096, int(info["nnz"] * scale))
    return rmat_csr(n, m, seed=seed)
