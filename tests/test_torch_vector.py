"""The port's sparse vectors, COO SpMSpV and sparse assigns against
`graphlily_tpu.ops` (and its modules), array for array.

Inputs come from one numpy seed and go to both packages. Indices and nnz
must be equal; values bit-equal, except arithmetic SpMSpV sums, which
agree within rtol 1e-6 (fp32 in another order). Mirrors
tests/test_ops.py:100-209.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.io import matrix as jmatrix
from graphlily_tpu.module import AssignVectorSparseModule as JaxAssignSparse

import graphlily_tpu_torch as tg
from graphlily_tpu_torch import ops as tops
from graphlily_tpu_torch.io import csr2csc, csc2csr, uniform_csr, rmat_csr
from graphlily_tpu_torch.module import AssignVectorSparseModule

from test_torch_io import to_jax, assert_same_csr

SEMIRINGS = ["arithmetic", "logical", "tropical"]
MASKS = [tg.MaskType.NO_MASK, tg.MaskType.WRITE_TO_ZERO,
         tg.MaskType.WRITE_TO_ONE]


def _to_jax_sv(sv):
    return jops.SparseVector(jnp.asarray(sv.indices.numpy()),
                             jnp.asarray(sv.values.numpy()),
                             jnp.asarray(sv.nnz.numpy()))


def _assert_same_sv(got, want, exact=True):
    n = int(want.nnz)
    assert int(got.nnz) == n and got.capacity == want.capacity
    assert got.indices.dtype == torch.int32 and got.nnz.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    if exact:
        np.testing.assert_array_equal(got.values.numpy().view(np.int32),
                                      np.asarray(want.values).view(np.int32))
    else:
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                                   rtol=1e-6, atol=1e-6)


def _dense(n, zero, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32) + 0.5
    x[rng.random(n) >= density] = zero
    return x


@pytest.mark.parametrize("capacity", [None, 1, 7, 40, 4096])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
@pytest.mark.parametrize("zero", [0.0, float(tg.FLOAT_INF)], ids=["0", "inf"])
def test_dense_to_sparse_matches(zero, density, capacity):
    """Ascending indices, truncation to the first `capacity` hits, nnz
    clamped, padding slots at index n-1 with values = dense[n-1]."""
    x = _dense(1000, zero, density, seed=3)
    got = tops.dense_to_sparse(torch.from_numpy(x), zero, capacity)
    want = jops.dense_to_sparse(jnp.asarray(x), zero, capacity)
    _assert_same_sv(got, want)
    assert int(got.nnz) == min(int((x != zero).sum()), capacity or 1000)


def test_dense_to_sparse_capacity_clamp():
    got = tops.dense_to_sparse(torch.arange(1, 33, dtype=torch.float32), 0.0,
                               capacity=8)
    assert int(got.nnz) == 8
    np.testing.assert_array_equal(got.indices.numpy(), np.arange(8))


@pytest.mark.parametrize("zero", [0.0, float(tg.FLOAT_INF)], ids=["0", "inf"])
@pytest.mark.parametrize("nnz", [0, 1, 5, 64])
def test_sparse_from_entries_and_to_dense_match(nnz, zero):
    """Entries beyond nnz are padding and are dropped by sparse_to_dense,
    even when they point at live indices."""
    rng = np.random.default_rng(nnz)
    idx = np.sort(rng.choice(500, size=nnz, replace=False))
    vals = rng.random(nnz).astype(np.float32)
    got = tops.sparse_from_entries(idx, vals, capacity=64)
    want = jops.sparse_from_entries(idx, vals, capacity=64)
    _assert_same_sv(got, want)
    for sv, jsv in ((got, want),
                    (got._replace(nnz=torch.tensor(nnz // 2, dtype=torch.int32)),
                     want._replace(nnz=jnp.asarray(nnz // 2, jnp.int32)))):
        d = tops.sparse_to_dense(sv, 500, zero)
        jd = np.asarray(jops.sparse_to_dense(jsv, 500, zero))
        np.testing.assert_array_equal(d.numpy(), jd)


def test_sparse_vector_roundtrip():
    rng = np.random.default_rng(12345)
    dense = rng.random(64).astype(np.float32)
    dense[rng.random(64) < 0.6] = 0.0
    sv = tops.dense_to_sparse(torch.from_numpy(dense), 0.0)
    assert int(sv.nnz) == (dense != 0).sum()
    np.testing.assert_array_equal(tops.sparse_to_dense(sv, 64, 0.0).numpy(),
                                  dense)


@pytest.mark.parametrize("build", [lambda: uniform_csr(150, 150, 5, seed=11),
                                   lambda: rmat_csr(3000, 40000, seed=5),
                                   lambda: uniform_csr(900, 2100, 3, seed=6)],
                         ids=["uniform", "rmat", "rect"])
def test_csc_matches(build):
    """csr2csc, csc2csr and coo_from_csc equal the JAX package's."""
    csr = build()
    csc = csr2csc(csr)
    jcsc = jmatrix.csr2csc(to_jax(csr))
    assert_same_csr(csc2csr(csc), jmatrix.csc2csr(jcsc))
    coo = tops.coo_from_csc(csc)
    jcoo = jops.coo_from_csc(jcsc)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(coo, f).numpy(),
                                      np.asarray(getattr(jcoo, f)))
    assert (coo.num_rows, coo.num_cols, coo.nnz) == (
        jcoo.num_rows, jcoo.num_cols, jcoo.nnz)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.99])
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_spmspv_coo_matches(name, mask_type, sparsity):
    csr = uniform_csr(150, 150, 5, seed=11)
    csc = csr2csc(csr)
    rng = np.random.default_rng(7)
    zero = tg.SEMIRINGS[name].zero
    nnz_vec = max(1, int(150 * (1 - sparsity)))
    idx = np.sort(rng.choice(150, size=nnz_vec, replace=False))
    vals = rng.random(nnz_vec).astype(np.float32) + 0.5
    mask = (rng.random(150) * 2).astype(np.float32)
    mask[rng.random(150) < 0.5] = zero
    for cap in (None, 16):
        got_sv, got = tops.spmspv_coo(
            tops.coo_from_csc(csc), tops.sparse_from_entries(idx, vals, 256),
            tg.SEMIRINGS[name], torch.from_numpy(mask), mask_type, cap)
        want_sv, want = jops.spmspv_coo(
            jops.coo_from_csc(jmatrix.csr2csc(to_jax(csr))),
            jops.sparse_from_entries(idx, vals, 256), jg.SEMIRINGS[name],
            jnp.asarray(mask), jg.MaskType(mask_type), cap)
        exact = name != "arithmetic"
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        _assert_same_sv(got_sv, want_sv, exact)


def test_assign_sparse_no_new_frontier_matches():
    rng = np.random.default_rng(1)
    inout = rng.random(50).astype(np.float32)
    for nnz in (3, 1, 0):
        sv = tops.sparse_from_entries([3, 17, 44], [1.0, 1.0, 1.0], 8)
        sv = sv._replace(nnz=torch.tensor(nnz, dtype=torch.int32))
        got = tops.assign_vector_sparse_no_new_frontier(
            torch.from_numpy(inout), sv, 7.0)
        want = jops.assign_vector_sparse_no_new_frontier(
            jnp.asarray(inout), _to_jax_sv(sv), 7.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() == 7.0).sum() == nnz


@pytest.mark.parametrize("capacity", [None, 2, 5])
def test_assign_sparse_new_frontier_matches(capacity):
    """The relaxation and the compacted new frontier (fill index
    capacity-1, nnz not clamped) equal JAX's."""
    inout = np.array([5.0, 1.0, 9.0, 4.0, 2.0, 8.0, 3.0], np.float32)
    sv = tops.sparse_from_entries([0, 1, 2, 4, 5, 6],
                                  [3.0, 2.0, 9.5, 1.0, 7.0, 2.5], 8)
    got_inout, got_nf = tops.assign_vector_sparse_new_frontier(
        torch.from_numpy(inout), sv, capacity)
    want_inout, want_nf = jops.assign_vector_sparse_new_frontier(
        jnp.asarray(inout), _to_jax_sv(sv), capacity)
    np.testing.assert_array_equal(got_inout.numpy(), np.asarray(want_inout))
    np.testing.assert_array_equal(got_inout.numpy(),
                                  [3.0, 1.0, 9.0, 4.0, 1.0, 7.0, 2.5])
    _assert_same_sv(got_nf, want_nf)
    assert int(got_nf.nnz) == 4


@pytest.mark.parametrize("frontier", [False, True], ids=["bfs", "sssp"])
def test_assign_sparse_module_matches(frontier):
    """AssignVectorSparseModule in both modes against the JAX module and
    the module's own numpy oracle."""
    rng = np.random.default_rng(5)
    inout = (rng.random(40) * 10).astype(np.float32)
    idx = np.sort(rng.choice(40, size=9, replace=False))
    vals = (rng.random(9) * 10).astype(np.float32)
    mod = AssignVectorSparseModule(frontier, tg.EngineConfig(device="cpu"))
    jmod = JaxAssignSparse(frontier, jg.EngineConfig())
    mod.send_inout_host_to_device(inout)
    jmod.send_inout_host_to_device(inout)
    mod.send_mask_host_to_device(tops.sparse_from_entries(idx, vals, 16))
    jmod.send_mask_host_to_device(jops.sparse_from_entries(idx, vals, 16))
    want64 = inout.copy()
    if frontier:
        mod.run()
        jmod.run()
        _assert_same_sv(mod.new_frontier_buf.value, jmod.new_frontier_buf.value)
        nf_idx, _ = mod.compute_reference_results_new_frontier(idx, vals,
                                                               want64)
        assert int(mod.new_frontier_buf.value.nnz) == len(nf_idx)
        with pytest.raises(ValueError):
            mod.run(1.0)
    else:
        mod.run(3.0)
        jmod.run(3.0)
        mod.compute_reference_results_no_new_frontier(idx, want64, 3.0)
        with pytest.raises(ValueError):
            mod.run()
    got = mod.send_inout_device_to_host()
    np.testing.assert_array_equal(got, jmod.send_inout_device_to_host())
    np.testing.assert_array_equal(got, want64)
