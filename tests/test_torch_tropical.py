"""The port's tropical engine on the CPU (plain PyTorch versions of K4
scatter in ADDMIN mode, K8/K9 split and K10 window reduce) against the JAX
package.

The graphs are the JAX tropical tests' (test_torch_fixtures.
TROPICAL_FIXTURES): RMAT at the production kb, a multi-region RMAT whose
regions drain between one another, a hub row whose digit cycles split
deposits, and a graph with empty rows. Cases:

  * the port's `pack_tropical` builds every array of JAX
    `pack_tropical(..., native=False)`, both split formats, both deals;
  * the block-mapped split targets (io/router_format.deposit_targets)
    equal a sequential walk of the descriptor stream, and the plain split
    equals a step-by-step emulation of the Pallas split kernel
    (tropical_pallas.py:45-130, accumulator slots carried across steps);
  * `TropicalSpMV` is bit-equal to JAX `spmv_coo` and to the float64
    oracle rounded to float32 (rounding is monotone, so it commutes with
    the min), with FLOAT_INF entries in x, both masks and a frontier that
    holds its source at distance 0;
  * the SpMSpV tropical branch and SSSP pull, push and pull_push on it
    equal JAX `spmspv_coo`, the JAX app and the oracles;
  * the ladder sends tropical graphs above 700,000 rows to it.

Slow cases hold the plain g1, window stream and window maxima bit for bit
against JAX's interpret-mode TropicalSpMV stages.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.apps import SSSP as JaxSSSP
from graphlily_tpu.io import matrix as jmatrix
from graphlily_tpu.io.tropical_format import (
    pack_tropical as jax_pack_tropical)

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.apps import SSSP
from graphlily_tpu_torch.io import (CSRMatrix, csr_from_coo, csr2csc,
                                    deposit_targets, pack_tropical,
                                    rmat_csr, util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule, SpMSpVModule
from graphlily_tpu_torch.module import spmspv_module as tspmspv
from graphlily_tpu_torch.module.spmv_module import resolve_engine
from graphlily_tpu_torch.ops import TropicalSpMV, sparse_from_entries

from test_torch_fixtures import TROPICAL_FIXTURES
from test_torch_io import to_jax

CPU = tg.EngineConfig(device="cpu")
INF = float(tg.FLOAT_INF)
FORMATS = ["planes", "triples"]
DEALS = ["free", "bucket"]
NO_LAUNCHES = {"xperm": 0, "scatter": 0, "scatter_pred": 0, "split": 0,
               "split_triples": 0, "window_reduce": 0}


@functools.lru_cache(maxsize=None)
def _layout(name, fmt, deal="free"):
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    csr = build()
    return csr, pack_tropical(csr, tg.EngineConfig(planar_deal=deal),
                              region_rows=region_rows, kb=kb,
                              split_format=fmt)


def _engine(name, fmt, deal="free", mask_type=tg.MaskType.NO_MASK):
    csr, lay = _layout(name, fmt, deal)
    return csr, TropicalSpMV(lay, tg.TropicalSemiring, CPU, mask_type)


def _x(n, seed=12345, inf_frac=0.3):
    """x >= 0 (distances) with unreached FLOAT_INF entries."""
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * 100).astype(np.float32)
    x[rng.random(n) < inf_frac] = INF
    return x


def _references(csr, x, mask=None, mask_type=tg.MaskType.NO_MASK):
    """JAX spmv_coo on the padded graph, and the float64 oracle rounded to
    float32."""
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, 1024, 1024)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jops.spmv_coo(
        jops.coo_from_csr(to_jax(padded)), jnp.asarray(x),
        jg.TropicalSemiring, jmask, jg.MaskType(mask_type)))
    mod = SpMVModule(tg.EngineConfig(engine="xla", device="cpu"))
    mod.set_semiring(tg.TropicalSemiring)
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(padded)
    return want, mod.compute_reference_results(x, mask).astype(np.float32)


def _assert_bits(got, *wants):
    got = np.asarray(got, np.float32)
    for want in wants:
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(want, np.float32).view(
                                          np.int32))


# ---- the layout ------------------------------------------------------------
def _assert_same_fields(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_pack_tropical_matches_jax(name, fmt, deal):
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    csr, lay = _layout(name, fmt, deal)
    jlay = jax_pack_tropical(to_jax(build()), jg.EngineConfig(
        planar_deal=deal), region_rows=region_rows, kb=kb, native=False,
        split_format=fmt)
    _assert_same_fields(lay, jlay, skip=("planar",))
    _assert_same_fields(lay.planar, jlay.planar)
    assert (lay.triples2 is not None) == (fmt == "triples")
    assert (lay.planar.triples is not None) == (fmt == "triples")
    if name == "multi_region":
        assert lay.planar.num_regions > 1 and lay.region_digits == 16


def _walk_targets(lay) -> np.ndarray:
    """Window chunk of each split deposit by walking the descriptor stream
    in order, as the Pallas split kernel runs it: per step all deposits,
    then all flushes; a flush empties its slot into chunk
    qblk2[t] * f2 + q."""
    want = np.full((lay.nsteps2, lay.dstep2), -1, np.int64)
    pending = {}
    for t in range(lay.nsteps2):
        for j in range(lay.rstep2):
            w2 = int(lay.rg2[t, j, 1])
            if j < lay.dstep2 and w2 > 0:
                pending.setdefault(w2 & 0xFFF, []).append((t, j))
            elif j >= lay.dstep2 and w2 < 0:
                chunk = int(lay.qblk2[t]) * lay.f2 + ((w2 >> 16) & 0xFF)
                for tt, jj in pending.pop(w2 & 0xFFF, []):
                    want[tt, jj] = chunk
    assert not any(pending.values()), "a deposit is never flushed"
    return want


@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_split_targets_match_sequential_walk(name):
    _, lay = _layout(name, "planes")
    got = deposit_targets(lay.rg2, lay.dstep2, lay.f2, block=lay.qblk2)
    np.testing.assert_array_equal(got, _walk_targets(lay))
    if name in ("multi_region", "hub_row"):
        # what the targets must handle: slots flushed more than once
        # (rotated cycles, drains) and steps that share a block
        w2 = lay.rg2[:, lay.dstep2:, 1]
        slots = w2[w2 < 0] & 0xFFF
        assert len(np.unique(slots)) < len(slots)
        assert lay.nblocks2 < lay.nsteps2


def _emulate_split(lay, g1: np.ndarray) -> np.ndarray:
    """The Pallas split kernel (planes format), step by step with its
    accumulator slots: deposits take a gathered plane into a slot, a flush
    copies the slot into its window chunk and zeroes it."""
    g1 = g1.reshape(-1, 8, 128)
    acc = np.zeros((lay.num_slots2, 8, 128), np.int32)
    out = np.zeros((len(lay.c_win), 8, 128), np.int32)
    for t in range(lay.nsteps2):
        gm = g1[lay.in_order[t * lay.kb:(t + 1) * lay.kb]]
        for j in range(lay.dstep2):
            w1, w2 = (int(v) for v in lay.rg2[t, j])
            if w2 > 0:
                pv = lay.planes2[t, w1 >> 8].astype(np.int32)
                g = np.take_along_axis(gm[w1 & 0xFF], pv & 127, axis=1)
                acc[w2 & 0xFFF] = np.where(pv < 0, g, acc[w2 & 0xFFF])
        for j in range(lay.dstep2, lay.rstep2):
            w2 = int(lay.rg2[t, j, 1])
            if w2 < 0:
                q = int(lay.qblk2[t]) * lay.f2 + ((w2 >> 16) & 0xFF)
                out[q] = acc[w2 & 0xFFF]
                acc[w2 & 0xFFF] = 0
    assert not acc.any(), "an accumulator slot was never flushed"
    return out


@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_split_plain_matches_emulated_pallas_split(name):
    """K8's plain version equals the emulated Pallas split on every chunk
    (unflushed chunks hold 0 in both), and K9's, on the triples layout of
    the same graph, equals K8's bit for bit."""
    _, eng = _engine(name, "planes")
    _, lay = _layout(name, "planes")
    g1 = np.random.default_rng(3).integers(
        1, 2**31 - 1, eng.g1_numel).astype(np.int32)
    got = eng.split(torch.from_numpy(g1)).numpy()
    np.testing.assert_array_equal(got, _emulate_split(lay, g1))
    _, eng_t = _engine(name, "triples")
    np.testing.assert_array_equal(
        eng_t.split(torch.from_numpy(g1)).numpy(), got)
    assert eng.launches == NO_LAUNCHES and eng_t.launches == NO_LAUNCHES


# ---- the engine ------------------------------------------------------------
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_spmv_bit_equal(name, fmt, deal):
    csr, eng = _engine(name, fmt, deal)
    x = _x(eng.num_cols)
    y = eng(torch.from_numpy(x))
    assert y.shape == (eng.num_rows,) and y.dtype == torch.float32
    assert eng.launches == NO_LAUNCHES
    _assert_bits(y.numpy(), *_references(csr, x))
    if name == "empty_rows":
        deg = np.diff(csr.adj_indptr.astype(np.int64))
        assert (deg == 0).any() and (y.numpy()[:csr.num_rows][deg == 0]
                                     == INF).all()


@pytest.mark.parametrize("mask_type", [tg.MaskType.WRITE_TO_ZERO,
                                       tg.MaskType.WRITE_TO_ONE],
                         ids=lambda m: m.name)
def test_tropical_spmv_masks(mask_type):
    csr, eng = _engine("multi_region", "planes", mask_type=mask_type)
    x = _x(eng.num_cols)
    mask = (np.random.default_rng(4).random(eng.num_rows) < 0.5).astype(
        np.float32)
    y = eng(torch.from_numpy(x), torch.from_numpy(mask))
    _assert_bits(y.numpy(), *_references(csr, x, mask, mask_type))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_predicated_frontier(name, fmt):
    """A frontier whose source sits at distance 0 in column tile 1 (x =
    FLOAT_INF elsewhere): the tile is active, K4p scatter's stream equals
    the unpredicated one, and the SpMSpV call is bit-equal to the SpMV and
    the references."""
    csr, eng = _engine(name, fmt)
    x = np.full(eng.num_cols, INF, np.float32)
    x[1024 + 7] = 0.0
    x[1024 + 500] = 3.0
    xt = torch.from_numpy(x)
    act = eng.activity(xt)
    assert act.tolist() == [int(t == 1) for t in range(eng.num_col_tiles)]
    np.testing.assert_array_equal(eng.scatter_predicated(xt, act).numpy(),
                                  eng.scatter(xt).numpy())
    y = eng.call_predicated(xt)
    _assert_bits(y.numpy(), eng(xt).numpy(), *_references(csr, x))
    empty = torch.full((eng.num_cols,), INF)
    assert not eng.activity(empty).any()
    assert bool((eng.call_predicated(empty) == INF).all())


def test_engine_takes_jax_layout():
    """A JAX package layout (plain numpy) drives the port's engine."""
    build, region_rows, kb = TROPICAL_FIXTURES["hub_row"]
    csr, eng = _engine("hub_row", "triples")
    jlay = jax_pack_tropical(to_jax(csr), jg.EngineConfig(),
                             region_rows=region_rows, kb=kb, native=False,
                             split_format="triples")
    x = torch.from_numpy(_x(eng.num_cols))
    _assert_bits(TropicalSpMV(jlay, tg.TropicalSemiring, CPU)(x).numpy(),
                 eng(x).numpy())


def test_wrappers_check_arguments():
    _, eng = _engine("rmat", "planes")
    with pytest.raises(ValueError, match="ADDMIN"):
        TropicalSpMV(_layout("rmat", "planes")[1], tg.ArithmeticSemiring,
                     CPU)
    with pytest.raises(ValueError, match="int32"):
        eng.split(torch.zeros(eng.g1_numel))
    with pytest.raises(ValueError, match="elements"):
        eng.window_reduce(torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        eng.scatter(torch.zeros(eng.num_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="never fuses"):
        eng.planar.fused_spmv(torch.zeros(eng.num_cols))


# ---- SpMSpV, SSSP and the ladder -------------------------------------------
@pytest.mark.parametrize("shared", [False, True], ids=["own", "reuse_from"])
def test_spmspv_tropical_branch(shared, monkeypatch):
    """SpMSpV on the tropical engine: its own (the chunked layout made
    infeasible) or shared from the SpMV module; equal to JAX spmspv_coo
    and to the module's oracle."""
    csr = rmat_csr(12000, 60000, seed=7)
    util_round_csr_matrix_dim(csr, 1024, 1024)
    spmv = None
    if shared:
        spmv = SpMVModule(tg.EngineConfig(engine="router", device="cpu"))
        spmv.set_semiring(tg.TropicalSemiring)
        spmv.load_and_format_matrix(csr)
    else:
        monkeypatch.setattr(tspmspv, "estimate_chunk_layout_gb",
                            lambda c: 3.0)
    mod = SpMSpVModule(tg.EngineConfig(engine="router", device="cpu"))
    mod.set_semiring(tg.TropicalSemiring)
    mod.load_and_format_matrix(csr2csc(csr), reuse_from=spmv)
    assert mod.engine_name == "tropical"
    assert isinstance(mod.engine, TropicalSpMV)
    assert (mod.engine is spmv.engine) if shared else True
    rng = np.random.default_rng(9)
    idx = np.sort(rng.choice(csr.num_cols, 300, replace=False))
    vals = rng.integers(0, 50, 300).astype(np.float32)
    vals[0] = 0.0
    sv, y = mod.apply(sparse_from_entries(idx, vals, mod.capacity))
    _, want = jops.spmspv_coo(
        jops.coo_from_csc(jmatrix.csr2csc(to_jax(csr))),
        jops.sparse_from_entries(idx, vals, capacity=mod.capacity),
        jg.TropicalSemiring)
    _assert_bits(y.numpy(), np.asarray(want),
                 mod.compute_reference_results((idx, vals)))
    assert int(sv.nnz) == int((y != INF).sum())


def test_sssp_on_tropical_engine():
    """SSSP with engine="router": SpMV and SpMSpV share one TropicalSpMV;
    pull, push and pull_push (thresholds 0.05, 0 and 1) equal the JAX app
    (engine "xla") and the float64 oracle."""
    g = rmat_csr(12000, 60000, seed=7)
    app = SSSP(tg.EngineConfig(engine="router", sort_rows_by_degree=True,
                               device="cpu"))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == "tropical"
    assert app.SpMSpV_.engine is app.SpMV_.engine
    jax_app = JaxSSSP(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    want = app.compute_reference_results(0, 6)
    runs = {"pull": (app.pull(0, 6), jax_app.pull(0, 6)),
            "push": (app.push(0, 6), jax_app.push(0, 6))}
    for th in (0.05, 0.0, 1.0):
        runs[f"pull_push {th}"] = (app.pull_push(0, 6, th),
                                   jax_app.pull_push(0, 6, th))
    for label, (got, jax_got) in runs.items():
        np.testing.assert_array_equal(got, np.asarray(jax_got),
                                      err_msg=label)
        np.testing.assert_array_equal(got, want, err_msg=label)
    assert 1 < (want < INF).sum() < g.num_rows
    assert app.SpMV_.engine.launches == NO_LAUNCHES


def test_ladder_sends_large_tropical_graphs_to_the_tropical_engine():
    """Above 700,000 rows the chunked layout is infeasible: tropical goes
    to the tropical engine (the others to a router), and a 720,896-row
    graph with 3,000 entries runs on it and equals the oracle."""
    n = 720_896
    big = CSRMatrix(n, n, np.ones(1, np.float32), np.zeros(1, np.uint32),
                    np.concatenate([[0], np.ones(n, np.uint32)]))
    assert resolve_engine(big, "auto", True) == "tropical"
    assert resolve_engine(big, "auto", False) in ("roll", "planar")
    small = rmat_csr(3000, 20000, seed=3)
    assert resolve_engine(small, "auto", True) == "chunked"
    assert resolve_engine(small, "router", True) == "tropical"
    rng = np.random.default_rng(0)
    csr = csr_from_coo(rng.integers(0, n, 3000), rng.integers(0, n, 3000),
                       np.ones(3000, np.float32), n, n)
    mod = SpMVModule(CPU)
    mod.set_semiring(tg.TropicalSemiring)
    mod.load_and_format_matrix(csr)
    assert mod.engine_name == "tropical"
    x = rng.integers(0, 50, n).astype(np.float32)
    np.testing.assert_array_equal(mod.apply(torch.from_numpy(x)).numpy(),
                                  mod.compute_reference_results(x))


# ---- JAX interpret-mode stages (slow) --------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("fmt", FORMATS)
def test_stages_bit_equal_to_jax_interpret(fmt):
    """The plain g1 on every deposited position, the window stream on every
    flushed chunk and the window maxima equal the Pallas stages of JAX's
    TropicalSpMV (interpret mode) on the same layout and x."""
    from graphlily_tpu.ops.router_pallas import _planar_scatter_call
    from graphlily_tpu.ops.tropical_pallas import (
        TropicalSpMV as JaxTropicalSpMV, _split_call, _split_call_triples,
        _window_reduce_call)
    build, region_rows, kb = TROPICAL_FIXTURES["multi_region"]
    jlay = jax_pack_tropical(to_jax(build()), jg.EngineConfig(),
                             region_rows=region_rows, kb=kb, native=False,
                             split_format=fmt)
    jeng = JaxTropicalSpMV(jlay, jg.TropicalSemiring,
                           jg.EngineConfig(interpret=True))
    _, eng = _engine("multi_region", fmt)
    x = _x(eng.num_cols)
    a = jeng.arrays
    g1j = np.asarray(_planar_scatter_call(
        a.a_page, a.a_r, a.a_vals, a.rg, a.planes,
        jnp.asarray(x).reshape(-1, 8, 128), a.a_sub,
        **jeng._static_scatter)).reshape(-1)
    gm = jnp.take(jnp.asarray(g1j).reshape(-1, 8, 128),
                  a.in_order.reshape(-1), axis=0).reshape(
        jlay.nsteps2, jlay.kb, 8, 128)
    if fmt == "triples":
        g2j = _split_call_triples(a.qblk2, a.rg2, gm, a.xsort2, a.triples2,
                                  **jeng._static_split)
    else:
        g2j = _split_call(a.qblk2, a.rg2, gm, a.planes2,
                          **jeng._static_split)
    blocks = np.asarray(_window_reduce_call(
        a.c_win, g2j, a.sort2, a.rowids, a.inv2,
        **jeng._static_reduce)).reshape(-1)
    g2j = np.asarray(g2j).reshape(-1, 8, 128)

    g1 = eng.scatter(torch.from_numpy(x))
    dst = eng.planar.plain_index()["dst"].numpy()
    np.testing.assert_array_equal(g1.numpy().reshape(-1)[dst], g1j[dst])
    g2 = eng.split(g1)
    flushed = jlay.c_win >= 0
    np.testing.assert_array_equal(g2.numpy()[flushed], g2j[flushed])
    np.testing.assert_array_equal(eng.window_reduce(g2).numpy(), blocks)
