"""The port's semirings, masks and reference ops against `graphlily_tpu`.

Inputs come from one numpy seed and go to both packages. Logical and
tropical results must be bit-equal; arithmetic SpMV sums in another order
and must agree within rtol 1e-6 (fp32, TF32 not involved on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu import semiring as jsr
from graphlily_tpu.io.formatter import util_round_csr_matrix_dim as jround
from graphlily_tpu.io.matrix import CSRMatrix as JCSRMatrix

import graphlily_tpu_torch as tg
from graphlily_tpu_torch import ops as tops
from graphlily_tpu_torch import semiring as tsr
from graphlily_tpu_torch.io import rmat_csr, util_round_csr_matrix_dim

SEMIRINGS = ["arithmetic", "logical", "tropical"]
MASKS = [tg.MaskType.NO_MASK, tg.MaskType.WRITE_TO_ZERO,
         tg.MaskType.WRITE_TO_ONE]


def _inputs(name: str, n: int, seed: int):
    """x and mask for one semiring: zeros in x and mask; FLOAT_INF entries
    in the tropical x (unreached vertices)."""
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32) + 0.5
    x[rng.random(n) < 0.3] = 0.0
    if name == "tropical":
        x[rng.random(n) < 0.2] = tg.FLOAT_INF
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return x, mask


def _check(got: torch.Tensor, want, name: str):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "arithmetic":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_semiring_ops_match(name):
    a, _ = _inputs(name, 4096, 1)
    b, _ = _inputs(name, 4096, 2)
    ts, js = tg.SEMIRINGS[name], jg.SEMIRINGS[name]
    assert (ts.op, ts.one, ts.zero) == (js.op, js.one, js.zero)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _check(ts.mul(ta, tb), js.mul(jnp.asarray(a), jnp.asarray(b)), name)
    _check(ts.add(ta, tb), js.add(jnp.asarray(a), jnp.asarray(b)), name)
    _check(ts.add_reduce(ta.reshape(64, 64), dim=1),
           js.add_reduce(jnp.asarray(a).reshape(64, 64), axis=1), name)


@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_masks_match(name, mask_type):
    y, mask = _inputs(name, 4096, 3)
    zero = tg.SEMIRINGS[name].zero
    ty, tm = torch.from_numpy(y), torch.from_numpy(mask)
    jy, jm = jnp.asarray(y), jnp.asarray(mask)
    _check(tsr.apply_mask(ty, tm, mask_type, zero),
           jsr.apply_mask(jy, jm, jsr.MaskType(mask_type), zero), name)
    _check(tsr.apply_mask_sparse_style(ty, tm, mask_type, zero),
           jsr.apply_mask_sparse_style(jy, jm, jsr.MaskType(mask_type), zero),
           name)


@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_spmv_coo_matches(name, mask_type):
    csr = rmat_csr(3000, 40000, seed=5)
    util_round_csr_matrix_dim(csr, 1024, 1024)
    jcsr = JCSRMatrix(csr.num_rows, csr.num_cols, csr.adj_data.copy(),
                      csr.adj_indices.copy(), csr.adj_indptr.copy())
    jround(jcsr, 1024, 1024)
    x, mask = _inputs(name, csr.num_cols, 4)
    got = tops.spmv_coo(tops.coo_from_csr(csr), torch.from_numpy(x),
                        tg.SEMIRINGS[name], torch.from_numpy(mask), mask_type)
    want = jops.spmv_coo(jops.coo_from_csr(jcsr), jnp.asarray(x),
                         jg.SEMIRINGS[name], jnp.asarray(mask),
                         jsr.MaskType(mask_type))
    _check(got, want, name)


@pytest.mark.parametrize("length", [None, 1000])
@pytest.mark.parametrize("val", [0.0, 0.1, 1.0 / 3.0])
def test_ewise_add_scalar_matches(val, length):
    x, _ = _inputs("arithmetic", 3072, 5)
    got = tops.ewise_add_scalar(torch.from_numpy(x), val, length)
    want = jops.ewise_add_scalar(jnp.asarray(x), val, length)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("mask_type", MASKS[1:], ids=lambda m: m.name)
@pytest.mark.parametrize("val", [2.0, 7.0, 0.1])
def test_assign_vector_dense_matches(mask_type, val):
    inout, mask = _inputs("arithmetic", 3072, 6)
    got = tops.assign_vector_dense(torch.from_numpy(inout),
                                   torch.from_numpy(mask), val, mask_type)
    want = jops.assign_vector_dense(jnp.asarray(inout), jnp.asarray(mask),
                                    val, jsr.MaskType(mask_type))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_assign_vector_dense_needs_mask_type():
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        tops.assign_vector_dense(v, v, 1.0, tg.MaskType.NO_MASK)
