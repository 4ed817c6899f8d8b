"""Graph fixtures shared by the port's tests (numpy and the port only, no
jax, so the card-only kernel tests can import them where jax is absent).

FIXTURES are the JAX router tests' fixtures (tests/test_router.py):
uniform, dense, mod-128 conflict, RMAT, multi-region and hub-page graphs,
plus the explicit region heights. PLANAR_FIXTURES are the JAX planar
tests' graphs (tests/test_planar.py): RMAT 9000/60k, two region heights,
the two-mega-column hub graph, and a uniform graph with several regions.
CHUNKED_FIXTURES are the JAX chunked-engine tests' graphs
(tests/test_spmv_pallas.py): uniform, dense, mod-128 conflict, RMAT, a
rectangular graph, empty window groups, empty rows and a hub row;
`hub_window_csr` puts thousands of chunks in one window.
TROPICAL_FIXTURES are the JAX tropical tests' graphs
(tests/test_tropical.py): RMAT at the production kb, a multi-region RMAT
with drains, a hub row and a graph with empty rows.
The tests here check that each is a well-formed CSR matrix and is rebuilt
identically.
"""
import numpy as np
import pytest

from graphlily_tpu_torch.io import (uniform_csr, dense_csr, conflict_csr,
                                    rmat_csr, util_round_csr_matrix_dim)
from graphlily_tpu_torch.io.matrix import CSRMatrix, csr_from_coo


def hub_page_csr() -> CSRMatrix:
    """One 128-column page receives edges from rows all over a 40K-row
    space: every A-chunk of that page spans all three regions."""
    rng = np.random.default_rng(4)
    n = 40000
    rows = rng.integers(0, n, 6000)
    cols = rng.integers(0, 128, 6000)
    vals = rng.random(6000).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * 128 + cols
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return CSRMatrix(n, n, vals, cols.astype(np.uint32),
                     np.cumsum(indptr).astype(np.uint32))


def hub_columns_csr() -> CSRMatrix:
    """RMAT 4096/30k plus two mega-columns: every other row points at
    columns 7 and 1300 (tests/test_planar.py, the free-deal hub case)."""
    rng = np.random.default_rng(11)
    work = rmat_csr(4096, 30000, seed=11)
    util_round_csr_matrix_dim(work, 1024, 1024)
    rows = np.arange(0, 4096, 2, dtype=np.int64)
    return csr_from_coo(
        np.concatenate([work.row_ids(), rows, rows]),
        np.concatenate([work.adj_indices[:work.nnz],
                        np.full(len(rows), 7), np.full(len(rows), 1300)]),
        np.concatenate([work.adj_data[:work.nnz],
                        rng.random(2 * len(rows)).astype(np.float32)]),
        work.num_rows, work.num_cols)


# name -> (builder, explicit region_rows or None)
FIXTURES = {
    "uniform": (lambda: uniform_csr(1500, 1500, 4, seed=21), None),
    "dense": (lambda: dense_csr(256, 256), None),
    "conflict": (lambda: conflict_csr(1024, 2048), None),
    "rmat": (lambda: rmat_csr(3000, 40000, seed=5), None),
    "multi_region": (lambda: uniform_csr(20000, 20000, 3, seed=11), None),
    "hub_page": (hub_page_csr, None),
    "region_1024": (lambda: rmat_csr(20000, 120000, seed=9), 1024),
    "region_4096": (lambda: rmat_csr(20000, 120000, seed=9), 4096),
    "region_16384": (lambda: rmat_csr(20000, 120000, seed=9), 16384),
}

PLANAR_FIXTURES = {
    "rmat": (lambda: rmat_csr(9000, 60000, seed=3), None),
    "region_1024": (lambda: rmat_csr(20000, 120000, seed=9), 1024),
    "region_4096": (lambda: rmat_csr(20000, 120000, seed=9), 4096),
    "hub_columns": (hub_columns_csr, None),
    "uniform": (lambda: uniform_csr(20000, 20000, 3, seed=11), None),
}


def hub_rows_csr() -> CSRMatrix:
    """One hub row with 700 nnz in one column tile (its lane runs fill
    whole chunks) plus 299 singleton rows (tests/test_spmv_pallas.py, the
    tropical hub-row case)."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.zeros(700, np.int64),
                           np.arange(1, 300, dtype=np.int64)])
    cols = np.concatenate([rng.integers(0, 1024, 700),
                           rng.integers(0, 1024, 299)])
    vals = rng.random(999).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(1025, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return CSRMatrix(1024, 1024, vals, cols.astype(np.uint32),
                     np.cumsum(indptr).astype(np.uint32))


def empty_windows_csr() -> CSRMatrix:
    """Rows beyond the first 100 empty, rounded to 4096 rows: three of the
    four window groups need all-padding filler chunks."""
    csr = uniform_csr(100, 3000, 4, seed=9)
    util_round_csr_matrix_dim(csr, 4096, 1024)
    return csr


def hub_window_csr() -> CSRMatrix:
    """Rows 0-127 dense over the first 128 columns of each of 32 column
    tiles (4,096 chunks, all in window 0: the atomics of thousands of
    chunks meet on 128 rows) plus an RMAT graph's rows 128 and up."""
    rng = np.random.default_rng(8)
    base = rmat_csr(4096, 30000, seed=8)
    keep = base.row_ids() >= 128
    hub_cols = (np.arange(32)[:, None] * 1024 + np.arange(128)).reshape(-1)
    dense_rows = np.repeat(np.arange(128, dtype=np.int64), len(hub_cols))
    dense_cols = np.tile(hub_cols, 128)
    return csr_from_coo(
        np.concatenate([dense_rows, base.row_ids()[keep]]),
        np.concatenate([dense_cols, base.adj_indices[:base.nnz][keep]]),
        np.concatenate([rng.random(len(dense_rows)).astype(np.float32),
                        base.adj_data[:base.nnz][keep]]),
        4096, 32 * 1024)


# the JAX chunked tests' graphs (tests/test_spmv_pallas.py)
CHUNKED_FIXTURES = {
    "uniform": lambda: uniform_csr(1500, 1500, 4, seed=21),
    "dense": lambda: dense_csr(256, 256),
    "conflict": lambda: conflict_csr(1024, 2048),
    "rmat": lambda: rmat_csr(3000, 40000, seed=5),
    "rect": lambda: uniform_csr(900, 2100, 3, seed=6),
    "empty_windows": empty_windows_csr,
    "tropical_empty_rows": lambda: uniform_csr(64, 1024, 3, seed=10),
    "hub_rows": hub_rows_csr,
}


def hub_row_csr() -> CSRMatrix:
    """Row 0 holds 5,000 entries among 20,000 random ones over 6,000 rows
    (tests/test_tropical.py, the hub-row case): its window's digit cycles
    split deposits, and its runs cross deposit boundaries."""
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.zeros(5000, np.int64),
                           rng.integers(0, 6000, 20000)])
    cols = rng.integers(0, 6000, 25000)
    vals = (rng.random(25000) * 10).astype(np.float32)
    return csr_from_coo(rows, cols, vals, 6000, 6000)


def empty_rows_csr() -> CSRMatrix:
    """A uniform 4000-row graph with every third row emptied: those rows
    have no entry and must come out as the tropical zero."""
    base = uniform_csr(4000, 4000, 3, seed=5)
    rows = base.row_ids()
    keep = rows % 3 != 0
    return csr_from_coo(rows[keep], base.adj_indices[:base.nnz][keep],
                        np.abs(base.adj_data[:base.nnz][keep]), 4000, 4000)


# the JAX tropical tests' graphs (tests/test_tropical.py): name -> (builder,
# explicit region_rows or None, split-pass kb); kb=4 keeps the interpret-
# mode kernels small, 16 is the production geometry
TROPICAL_FIXTURES = {
    "rmat": (lambda: rmat_csr(3000, 20000, seed=3), None, 16),
    "multi_region": (lambda: rmat_csr(12000, 60000, seed=7), 2048, 4),
    "hub_row": (hub_row_csr, 2048, 4),
    "empty_rows": (empty_rows_csr, None, 4),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(FIXTURES[name][0])


@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_planar_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(PLANAR_FIXTURES[name][0])


@pytest.mark.parametrize("name", [*CHUNKED_FIXTURES, "hub_window"])
def test_chunked_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(
        CHUNKED_FIXTURES.get(name, hub_window_csr))


@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(TROPICAL_FIXTURES[name][0])


def _check_well_formed_and_deterministic(build):
    a, b = build(), build()
    ptr = a.adj_indptr.astype(np.int64)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    assert len(ptr) == a.num_rows + 1 and ptr[-1] == len(a.adj_indices)
    assert int(a.adj_indices.max()) < a.num_cols
    for field in ("adj_data", "adj_indices", "adj_indptr"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
