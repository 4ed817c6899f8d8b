"""The port's planar-router engine on the CPU (plain PyTorch versions of K4
scatter, K4 fused, K3 and K5) against the JAX package.

Each case packs the same graph with the port, runs `PlanarSpMV` fused and
split for both deals, and compares with JAX `spmv_coo` on the padded graph
and with the float64 oracle: logical results bit-equal, arithmetic within
max|y - ref| <= 1e-5 * max|ref| (the plain versions sum in another order
than both references), the tolerance of test_torch_router.py. The deposit
targets are held to the packer's own record of where each nnz lands
(`keep_el_stream`). One slow case holds K4's plain flush stream bit for
bit against JAX `PlanarSpMV.scatter` in Pallas interpret mode.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu.io.planar_format import pack_planar as jax_pack_planar
from graphlily_tpu.ops.router_pallas import PlanarSpMV as JaxPlanarSpMV

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import pack_planar
from graphlily_tpu_torch.ops import PlanarSpMV

from test_torch_fixtures import PLANAR_FIXTURES
from test_torch_io import to_jax
from test_torch_router import (CPU, MASKS, _assert_matches, _references,
                               _vectors)

DEALS = ["free", "bucket"]
NO_LAUNCHES = {"fused": 0, "scatter": 0, "reduce": 0, "xperm": 0,
               "fused_pred": 0, "scatter_pred": 0, "reduce_pred": 0}


def _pack(name, deal, **kw):
    build, region_rows = PLANAR_FIXTURES[name]
    csr = build()
    return csr, pack_planar(csr, region_rows=region_rows, deal=deal, **kw)


def _run(name, semiring, mask_type, fused, deal):
    csr, lay = _pack(name, deal)
    eng = PlanarSpMV(lay, tg.SEMIRINGS[semiring], CPU, mask_type)
    assert eng.chained == (deal == "free")
    eng.fused = fused
    x, mask = _vectors(lay)
    y = eng(torch.from_numpy(x), torch.from_numpy(mask))
    assert eng.launches == NO_LAUNCHES
    assert y.shape == (lay.num_rows,)
    return csr, y, x, mask


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
def test_planar_semirings_masks(name, mask_type, fused, deal):
    csr, y, x, mask = _run("rmat", name, mask_type, fused, deal)
    _assert_matches(y, *_references(csr, name, x, mask, mask_type), name)


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("fixture", [k for k in PLANAR_FIXTURES
                                     if k != "rmat"])
def test_planar_fixtures(fixture, name, fused, deal):
    csr, y, x, mask = _run(fixture, name, tg.MaskType.NO_MASK, fused, deal)
    _assert_matches(y, *_references(csr, name, x, mask,
                                     tg.MaskType.NO_MASK), name)


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fixture", list(PLANAR_FIXTURES))
def test_scatter_lands_every_product_at_its_el_stream_position(fixture,
                                                               deal):
    """The deposit targets put val * x[col] of every nnz exactly where the
    packer recorded it (`el_stream`), and nothing anywhere else."""
    csr, lay = _pack(fixture, deal, keep_el_stream=True)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    x = np.random.default_rng(5).random(lay.num_cols).astype(np.float32) + 1
    stream = eng.scatter(torch.from_numpy(x)).reshape(-1).numpy()
    nnz = csr.nnz
    cols = csr.adj_indices[:nnz].astype(np.int64)
    want = csr.adj_data[:nnz].astype(np.float32) * x[cols]
    got = stream[lay.el_stream]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rest = np.ones(len(stream), bool)
    rest[lay.el_stream] = False
    assert len(np.unique(lay.el_stream)) == nnz
    assert not stream[rest].any()


@pytest.mark.parametrize("deal", DEALS)
def test_engine_takes_jax_layout(deal):
    """A JAX package layout (plain numpy) drives the port's engine and
    gives the same result as the port's own layout."""
    csr, lay = _pack("rmat", deal)
    jlay = jax_pack_planar(to_jax(csr), deal=deal, native=False)
    x, _ = _vectors(lay)
    xt = torch.from_numpy(x)
    for name in ("arithmetic", "logical"):
        a = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)(xt)
        b = PlanarSpMV(jlay, tg.SEMIRINGS[name], CPU)(xt)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("deal", DEALS)
def test_plain_versions_compose(deal):
    """K4 fused's plain version is K4 scatter's followed by K3's; the flush
    stream holds exactly the layout's nnz (every product lands once)."""
    _, lay = _pack("hub_columns", deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    x = torch.ones(lay.num_cols)
    stream = eng.scatter(x)
    assert stream.shape == (lay.nsteps, lay.f, 8, 128)
    assert int((stream != 0).sum()) == lay.nnz
    np.testing.assert_array_equal(eng.fused_spmv(x).numpy(),
                                  eng.reduce(stream).numpy())


def test_xperm_plain_matches_the_column_relayout():
    """K5's plain version puts x[c] at column c's (sublane, lane) slot of
    its tile, and 0 where no column lands."""
    csr, lay = _pack("rmat", "bucket")
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    x = np.random.default_rng(2).random(lay.num_cols).astype(np.float32) + 1
    x2 = eng.xperm(torch.from_numpy(x)).numpy().reshape(-1, 8, 128)
    want = np.zeros_like(x2)
    t, s, d, l = np.nonzero(lay.xperm < 0)
    want[t, d, l] = x[t * 1024 + s * 128 + (lay.xperm[t, s, d, l] & 127)]
    np.testing.assert_array_equal(x2, want)
    assert (x2 != 0).sum() == lay.num_cols   # every column lands once


def test_wrappers_check_arguments():
    _, lay = _pack("rmat", "free")
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    with pytest.raises(ValueError, match="float32"):
        eng.fused_spmv(torch.zeros(lay.num_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="elements"):
        eng.scatter(torch.zeros(lay.num_cols + 1))
    with pytest.raises(ValueError, match="elements"):
        eng.reduce(torch.zeros(7))
    with pytest.raises(ValueError, match="xperm"):
        eng.xperm(torch.zeros(lay.num_cols))
    with pytest.raises(ValueError):
        PlanarSpMV(lay, tg.TropicalSemiring, CPU)
    assert tg.EngineConfig(planar_deal="permc").planar_deal == "permc"
    with pytest.raises(ValueError, match="planar_deal"):
        tg.EngineConfig(planar_deal="snake")


def test_resolve_device_raises_without_a_card(monkeypatch):
    """With no device named, the config resolves the card, and raises
    where there is none instead of giving the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.EngineConfig().resolve_device()
    assert tg.EngineConfig(device="cpu").resolve_device() == torch.device(
        "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tg.EngineConfig().resolve_device() == torch.device("cuda")


def test_port_imports_no_jax():
    """The port, planar and PERM-C engines and the native loader included,
    loads neither jax nor the JAX package (the card's machine has no
    jax)."""
    code = ("import sys, graphlily_tpu_torch, graphlily_tpu_torch.apps, "
            "graphlily_tpu_torch.ops.planar, graphlily_tpu_torch.module, "
            "graphlily_tpu_torch.io.permc_format, "
            "graphlily_tpu_torch.native\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'graphlily_tpu')))")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.mark.slow
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
def test_scatter_stream_bit_equal_to_jax_interpret(name, deal):
    """K4's plain flush stream equals the Pallas planar scatter kernel's
    (run in interpret mode) bit for bit on every chunk that holds a flush.
    The Pallas kernel never writes the other chunks (c_code = -1, which
    the reduce skips), so they hold whatever the buffer held; the port's
    are zero."""
    csr, lay = _pack("rmat", deal)
    jlay = jax_pack_planar(to_jax(csr), deal=deal, native=False)
    x, _ = _vectors(jlay)
    want = np.asarray(JaxPlanarSpMV(
        jlay, jg.SEMIRINGS[name], jg.EngineConfig(interpret=True)).scatter(
            jnp.asarray(x)))
    got = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU).scatter(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    flushed = (jlay.c_code >= 0).reshape(jlay.nsteps, jlay.f)
    assert flushed.sum() > 0
    np.testing.assert_array_equal(got[flushed].view(np.int32),
                                  want[flushed].view(np.int32))
    assert not got[~flushed].any()
