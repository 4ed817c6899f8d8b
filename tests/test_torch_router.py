"""The port's roll-router engine on the CPU (plain PyTorch versions of
K1-K3) against the JAX package.

Each case packs the same graph with the port, runs `RouterSpMV` fused and
split, and compares with JAX `spmv_coo` on the padded graph and with the
float64 oracle: logical results bit-equal, arithmetic within
max|y - ref| <= 1e-5 * max|ref| (the plain versions sum in another order
than both references). One slow case holds K2's plain flush stream bit
for bit against JAX `RouterSpMV.scatter` in Pallas interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.io.router_format import pack_router as jax_pack_router
from graphlily_tpu.ops.router_pallas import RouterSpMV as JaxRouterSpMV

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import pack_router, util_round_csr_matrix_dim
from graphlily_tpu_torch.module import SpMVModule
from graphlily_tpu_torch.ops import RouterSpMV

from test_torch_fixtures import FIXTURES
from test_torch_io import to_jax

CPU = tg.EngineConfig(device="cpu")
MASKS = [tg.MaskType.NO_MASK, tg.MaskType.WRITE_TO_ZERO,
         tg.MaskType.WRITE_TO_ONE]


def _vectors(lay, seed=12345):
    rng = np.random.default_rng(seed)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = 0.0
    mask = (rng.random(lay.num_rows) < 0.5).astype(np.float32)
    return x, mask


def _references(csr, name, x, mask, mask_type):
    """JAX spmv_coo on the padded graph, and the float64 oracle."""
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, 1024, 1024)
    want = np.asarray(jops.spmv_coo(
        jops.coo_from_csr(to_jax(padded)), jnp.asarray(x),
        jg.SEMIRINGS[name], jnp.asarray(mask), jg.MaskType(mask_type)))
    mod = SpMVModule(tg.EngineConfig(engine="xla", device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[name])
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(padded)
    return want, mod.compute_reference_results(x, mask)


def _assert_matches(y, want, want64, name):
    y = y.numpy()
    if name == "logical":
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(y.astype(np.float64), want64)
    else:
        for ref in (want.astype(np.float64), want64):
            assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def _run(csr, name, mask_type, fused, region_rows=None):
    lay = pack_router(csr, region_rows=region_rows)
    eng = RouterSpMV(lay, tg.SEMIRINGS[name], CPU, mask_type)
    eng.fused = fused
    x, mask = _vectors(lay)
    y = eng(torch.from_numpy(x), torch.from_numpy(mask))
    assert eng.launches == {"fused": 0, "scatter": 0, "reduce": 0,
                            "fused_pred": 0, "scatter_pred": 0,
                            "reduce_pred": 0}
    return y, x, mask, lay


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
def test_router_semirings_masks(name, mask_type, fused):
    csr = FIXTURES["uniform"][0]()
    y, x, mask, _ = _run(csr, name, mask_type, fused)
    _assert_matches(y, *_references(csr, name, x, mask, mask_type), name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("fixture", [k for k in FIXTURES if k != "uniform"])
def test_router_fixtures(fixture, name, fused):
    build, region_rows = FIXTURES[fixture]
    csr = build()
    y, x, mask, lay = _run(csr, name, tg.MaskType.NO_MASK, fused,
                           region_rows)
    if region_rows is not None:
        assert lay.region_rows == region_rows
    if fixture == "multi_region":
        assert lay.num_regions == 2
    if fixture == "hub_page":
        assert lay.num_regions == 3
    _assert_matches(y, *_references(csr, name, x, mask,
                                     tg.MaskType.NO_MASK), name)


def test_engine_takes_jax_layout():
    """A JAX package layout (plain numpy) drives the port's engine and
    gives the same result as the port's own layout."""
    csr = FIXTURES["rmat"][0]()
    lay = pack_router(csr)
    jlay = jax_pack_router(to_jax(csr), native=False)
    x, _ = _vectors(lay)
    xt = torch.from_numpy(x)
    for name in ("arithmetic", "logical"):
        a = RouterSpMV(lay, tg.SEMIRINGS[name], CPU)(xt)
        b = RouterSpMV(jlay, tg.SEMIRINGS[name], CPU)(xt)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_versions_compose():
    """K1's plain version is K2's followed by K3's; the flush stream holds
    exactly the layout's nnz (every product lands once)."""
    csr = FIXTURES["hub_page"][0]()
    lay = pack_router(csr)
    eng = RouterSpMV(lay, tg.ArithmeticSemiring, CPU)
    x = torch.ones(lay.num_cols)
    stream = eng.scatter(x)
    assert stream.shape == (lay.nsteps, lay.f, 8, 128)
    assert int((stream != 0).sum()) == lay.nnz
    np.testing.assert_array_equal(eng.fused_spmv(x).numpy(),
                                  eng.reduce(stream).numpy())


def test_wrappers_check_arguments():
    lay = pack_router(FIXTURES["rmat"][0]())
    eng = RouterSpMV(lay, tg.ArithmeticSemiring, CPU)
    with pytest.raises(ValueError, match="float32"):
        eng.fused_spmv(torch.zeros(lay.num_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="elements"):
        eng.scatter(torch.zeros(lay.num_cols + 1))
    with pytest.raises(ValueError, match="elements"):
        eng.reduce(torch.zeros(7))
    with pytest.raises(ValueError):
        RouterSpMV(lay, tg.TropicalSemiring, CPU)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
def test_scatter_stream_bit_equal_to_jax_interpret(name):
    """K2's plain flush stream equals the Pallas scatter kernel's (run in
    interpret mode) bit for bit on every chunk that holds a flush. The
    Pallas kernel never writes the other chunks (c_code = -1, which the
    reduce skips), so they hold whatever the buffer held; the port's are
    zero."""
    csr = FIXTURES["multi_region"][0]()
    jlay = jax_pack_router(to_jax(csr), native=False)
    x, _ = _vectors(jlay)
    want = np.asarray(JaxRouterSpMV(
        jlay, jg.SEMIRINGS[name], jg.EngineConfig(interpret=True)).scatter(
            jnp.asarray(x)))
    got = RouterSpMV(pack_router(csr), tg.SEMIRINGS[name], CPU).scatter(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    flushed = (jlay.c_code >= 0).reshape(jlay.nsteps, jlay.f)
    assert flushed.sum() > 0
    np.testing.assert_array_equal(got[flushed].view(np.int32),
                                  want[flushed].view(np.int32))
    assert not got[~flushed].any()
