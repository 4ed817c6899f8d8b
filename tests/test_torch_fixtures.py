"""Graph fixtures shared by the port's tests (numpy and the port only, no
jax, so the card-only kernel tests can import them where jax is absent).

FIXTURES are the JAX router tests' fixtures (tests/test_router.py):
uniform, dense, mod-128 conflict, RMAT, multi-region and hub-page graphs,
plus the explicit region heights. PLANAR_FIXTURES are the JAX planar
tests' graphs (tests/test_planar.py): RMAT 9000/60k, two region heights,
the two-mega-column hub graph, and a uniform graph with several regions.
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


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(FIXTURES[name][0])


@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_planar_fixture_is_well_formed_and_deterministic(name):
    _check_well_formed_and_deterministic(PLANAR_FIXTURES[name][0])


def _check_well_formed_and_deterministic(build):
    a, b = build(), build()
    ptr = a.adj_indptr.astype(np.int64)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    assert len(ptr) == a.num_rows + 1 and ptr[-1] == len(a.adj_indices)
    assert int(a.adj_indices.max()) < a.num_cols
    for field in ("adj_data", "adj_indices", "adj_indptr"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
