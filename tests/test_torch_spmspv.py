"""The port's SpMSpV module and its frontier predication on the CPU (the
predicated kernels' plain PyTorch versions) against the JAX package.

* `SpMSpVModule.apply_dense` / `apply` against JAX `SpMSpVModule`
  (engine="xla") and the float64 oracle, on every port engine the ladder
  gives SpMSpV: the chunked engine (chunk_order="col"), the roll router
  and the planar router (both deals, shared from an SpMV module through
  `reuse_from`) and COO; every semiring the engine takes, every mask, and
  frontiers empty, 1 vertex, 5% and full. Logical and tropical results
  bit-equal to JAX (tropical within one fp32 rounding of the oracle),
  arithmetic within rtol 1e-5.
* The live sets, as dense boolean arrays, against JAX's XLA-only
  predication helpers on the same layout and frontier: chunk activity
  (`_chunk_activity`, per page for roll, per tile for planar), live
  deposits (`_predicate_rg`'s w2 > 0), live flush chunks
  (`_predicate_exact`'s cmask, with `qmap` built) and K7p's kept batches
  (`step_touch @ act > 0`).
* Each predicated engine call equals the unpredicated one on the same
  dense frontier, bit for bit (the plain versions drop only zero terms).

Graphs: the apps tests' RMAT 3000 / 40k (roll, chunked, COO) and RMAT
50000 / 150k (planar), plus router, planar and chunked fixtures.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu.io import matrix as jmatrix
from graphlily_tpu.module import SpMSpVModule as JaxSpMSpVModule
from graphlily_tpu.ops import sparse_from_entries as jsparse_from_entries
from graphlily_tpu.ops.router_pallas import (_chunk_activity, _predicate_rg,
                                             _predicate_exact, _flush_index,
                                             _rg_flat)

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import (rmat_csr, csr2csc, pack_router,
                                    pack_planar, pack_csr_chunks,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule, SpMSpVModule
from graphlily_tpu_torch.module import spmv_module as tspmv
from graphlily_tpu_torch.ops import (RouterSpMV, PlanarSpMV, ChunkedSpMV,
                                     TropicalSpMV, sparse_from_entries)

from test_torch_fixtures import (FIXTURES, PLANAR_FIXTURES, CHUNKED_FIXTURES,
                                 one_thread)
from test_torch_io import to_jax

CPU = tg.EngineConfig(device="cpu")
MASKS = [tg.MaskType.NO_MASK, tg.MaskType.WRITE_TO_ZERO,
         tg.MaskType.WRITE_TO_ONE]
FRONTIERS = ["empty", "one", "5pct", "full"]
# engine -> (graph, SpMV engine to share or None, planar deal, semirings)
ENGINES = {
    "chunked": ("rmat", None, "free", ["arithmetic", "logical", "tropical"]),
    "roll": ("rmat", "router", "free", ["arithmetic", "logical"]),
    "planar_free": ("hypersparse", "router", "free",
                    ["arithmetic", "logical"]),
    "planar_bucket": ("hypersparse", "router", "bucket",
                      ["arithmetic", "logical"]),
    "xla": ("rmat", None, "free", ["arithmetic", "logical", "tropical"]),
}
CASES = [(e, s) for e, spec in ENGINES.items() for s in spec[3]]


@functools.cache
def _graph(name):
    g = (rmat_csr(3000, 40000, seed=5) if name == "rmat"
         else rmat_csr(50000, 150000, seed=5))
    util_round_csr_matrix_dim(g, 1024, 1024)
    return g


@functools.cache
def _modules(engine, name):
    """(port SpMSpV module, JAX SpMSpV module on COO) for one engine."""
    graph, share, deal, _ = ENGINES[engine]
    g = _graph(graph)
    cfg = tg.EngineConfig(engine="auto" if engine == "chunked" else
                          ("xla" if engine == "xla" else "router"),
                          device="cpu", planar_deal=deal)
    reuse = None
    if share is not None:
        reuse = SpMVModule(cfg)
        reuse.set_semiring(tg.SEMIRINGS[name])
        reuse.load_and_format_matrix(g)
    mod = SpMSpVModule(cfg)
    mod.set_semiring(tg.SEMIRINGS[name])
    mod.load_and_format_matrix(csr2csc(g), reuse_from=reuse)
    assert mod.engine_name == engine.split("_")[0]
    if reuse is not None:
        assert mod.engine is reuse.engine
    jmod = JaxSpMSpVModule(jg.EngineConfig(engine="xla"))
    jmod.set_semiring(jg.SEMIRINGS[name])
    jmod.load_and_format_matrix(jmatrix.csr2csc(to_jax(g)))
    return mod, jmod


def _frontier(n, kind, zero, seed=3):
    """(indices, values) of an empty, one-vertex, 5% or full frontier;
    values >= 0.5 (tropical x >= 0)."""
    rng = np.random.default_rng(seed)
    k = {"empty": 0, "one": 1, "5pct": max(1, n // 20), "full": n}[kind]
    idx = np.sort(rng.choice(n, size=k, replace=False))
    vals = rng.random(k).astype(np.float32) + 0.5
    x = np.full(n, zero, np.float32)
    x[idx] = vals
    return idx, vals, x


def _mask(n, zero, seed=4):
    rng = np.random.default_rng(seed)
    m = (rng.random(n) * 2).astype(np.float32)
    m[rng.random(n) < 0.5] = zero
    return m


def _assert_close(got, want, name, err="", oracle=False):
    """Arithmetic within rtol 1e-5; logical and tropical bit-equal to JAX;
    tropical within one fp32 rounding of the float64 oracle (which adds
    x + val in fp64)."""
    got = np.asarray(got)
    if name == "arithmetic":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=err)
    elif name == "tropical" and oracle:
        np.testing.assert_allclose(got, want, rtol=2.0**-23, atol=0,
                                   err_msg=err)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err)


@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("engine,name", CASES)
def test_module_matches_jax_and_oracle(engine, name, mask_type):
    mod, jmod = _modules(engine, name)
    mod.set_mask_type(mask_type)
    jmod.set_mask_type(jg.MaskType(mask_type))
    zero = tg.SEMIRINGS[name].zero
    n = mod.get_num_cols()
    mask = _mask(mod.get_num_rows(), zero)
    tmask = torch.from_numpy(mask) if mask_type != tg.MaskType.NO_MASK \
        else None
    jmask = jnp.asarray(mask) if mask_type != tg.MaskType.NO_MASK else None
    for kind in FRONTIERS:
        idx, vals, x = _frontier(n, kind, zero)
        want64 = mod.compute_reference_results((idx, vals), mask)
        y = mod.apply_dense(torch.from_numpy(x), tmask)
        jy, jnnz = jmod.apply_dense(jnp.asarray(x), jmask)
        nnz = (y != zero).sum()
        assert y.shape == (mod.get_num_rows(),)
        _assert_close(y.numpy(), np.asarray(jy), name, kind)
        _assert_close(y.numpy(), want64, name, kind, oracle=True)
        assert int(nnz) == int(jnnz) == int((want64 != zero).sum())
        sv = sparse_from_entries(idx, vals, mod.capacity)
        sv_out, y2 = mod.apply(sv, tmask)
        jsv_out, jy2 = jmod.apply(jsparse_from_entries(idx, vals,
                                                       jmod.capacity), jmask)
        _assert_close(y2.numpy(), np.asarray(jy2), name, kind)
        assert int(sv_out.nnz) == int(jsv_out.nnz)
        np.testing.assert_array_equal(sv_out.indices.numpy(),
                                      np.asarray(jsv_out.indices))
        _assert_close(sv_out.values.numpy(), np.asarray(jsv_out.values), name)
        if kind == "empty":
            assert int(nnz) == 0 and (y.numpy() == zero).all()
    if mod.engine is not None:
        assert not any(mod.engine.launches.values())


@pytest.mark.parametrize("engine", ["chunked", "roll", "planar_free"])
def test_module_run_and_buffers(engine):
    """send / run / read back through DeviceBuffers, the nnz readback,
    and the oracle, as the reference call sequence does."""
    mod, _ = _modules(engine, "logical")
    mod.set_mask_type(tg.MaskType.WRITE_TO_ZERO)
    n = mod.get_num_cols()
    idx, vals, _ = _frontier(n, "5pct", 0.0, seed=9)
    mask = _mask(n, 0.0, seed=10)
    mod.send_vector_host_to_device((idx, vals))
    mod.send_mask_host_to_device(mask)
    mod.run()
    out = mod.send_results_device_to_host()
    want = mod.compute_reference_results((idx, vals), mask)
    assert mod.get_results_nnz() == int((want != 0).sum())
    got = np.zeros(n)
    k = mod.get_results_nnz()
    got[out.indices[:k].numpy()] = out.values[:k].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mod.send_mask_device_to_host(), mask)
    mod.set_mask_type(tg.MaskType.NO_MASK)


# ---- live sets against the JAX predication helpers -----------------------
def _activity(n_units, kind, seed=5):
    rng = np.random.default_rng(seed)
    k = {"empty": 0, "one": 1, "5pct": max(1, n_units // 20),
         "full": n_units}[kind]
    act = np.zeros(n_units, bool)
    act[rng.choice(n_units, size=k, replace=False)] = True
    return act


def _jax_live_sets(lay, act, flavor):
    """JAX's chunk activity (nsteps, cb), live deposits (nsteps, dstep)
    and live flush chunks (nsteps*f,) for one layout and activity."""
    a_page = jnp.asarray(lay.a_page.reshape(lay.nsteps, 1, lay.cb))
    a_sub = (None if flavor == "planar" else
             jnp.asarray(lay.a_sub.reshape(lay.nsteps, lay.cb * 8, 128)))
    act_chunk = _chunk_activity(a_page, a_sub, jnp.asarray(act),
                                lay.num_col_tiles)
    rg = jnp.asarray(_rg_flat(lay.rg))
    w2 = np.asarray(_predicate_rg(rg, act_chunk, flavor))[:, 0, 1::2]
    fidx = {k: jnp.asarray(v) for k, v in
            _flush_index(lay.rg, lay.dstep, lay.f).items()}
    _, cmask, _, na = _predicate_exact(rg, act_chunk, flavor, fidx)
    return (np.asarray(act_chunk).astype(bool),
            w2[:, :lay.dstep] > 0, np.asarray(cmask).reshape(-1))


def _check_live_sets(eng, lay, act, flavor):
    want_chunk, want_dep, want_flush = _jax_live_sets(lay, act, flavor)
    tact = torch.from_numpy(act.astype(np.uint8))
    got_chunk = tact.bool()[eng.chunk_units()].numpy()
    np.testing.assert_array_equal(got_chunk.reshape(want_chunk.shape),
                                  want_chunk)
    np.testing.assert_array_equal(eng.live_deposits(tact).numpy(), want_dep)
    np.testing.assert_array_equal(eng.live_chunks(tact).numpy().astype(bool),
                                  want_flush)
    return int(want_dep.sum()), int(want_flush.sum())


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("fixture", ["rmat", "multi_region", "hub_page",
                                     "region_1024"])
def test_roll_live_sets_match_jax(fixture, kind):
    """Page activity: a roll A-chunk's page is a_page*8 + the sublane byte
    of its first element, as JAX reads it (a_sub[:, 0::8, 0])."""
    build, region_rows = FIXTURES[fixture]
    lay = pack_router(build(), region_rows=region_rows)
    eng = RouterSpMV(lay, tg.LogicalSemiring, CPU)
    act = _activity(lay.num_col_tiles * 8, kind)
    ndep, nflush = _check_live_sets(eng, lay, act, "roll")
    if kind == "empty":
        assert ndep == nflush == 0
    if kind == "full":
        assert ndep == int((lay.rg[:, :lay.dstep, 1] > 0).sum())


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("fixture", ["rmat", "region_1024", "hub_columns"])
def test_planar_live_sets_match_jax(fixture, deal, kind):
    """Tile activity: a planar A-chunk mixes its tile's 8 pages."""
    build, region_rows = PLANAR_FIXTURES[fixture]
    lay = pack_planar(build(), region_rows=region_rows, deal=deal)
    eng = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    act = _activity(lay.num_col_tiles, kind)
    ndep, nflush = _check_live_sets(eng, lay, act, "planar")
    if kind == "empty":
        assert ndep == nflush == 0


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("fixture", ["uniform", "rmat", "conflict",
                                     "empty_windows", "hub_rows"])
def test_kept_batches_match_step_touch(fixture, kind):
    """The batches holding a chunk K7p folds equal JAX's `touch @ act > 0`,
    and the tile activity read from x is the frontier's."""
    lay = pack_csr_chunks(CHUNKED_FIXTURES[fixture](), chunk_order="col")
    eng = ChunkedSpMV(lay, tg.LogicalSemiring, CPU)
    act = _activity(lay.num_col_tiles, kind)
    want = np.asarray(jnp.asarray(lay.step_touch)
                      @ jnp.asarray(act.astype(np.float32))) > 0
    got = eng.kept_batches(torch.from_numpy(act)).numpy()
    np.testing.assert_array_equal(got, want)
    x = np.zeros(lay.num_cols, np.float32)
    x.reshape(lay.num_col_tiles, -1)[act, 0] = 1.0
    tact = eng.tile_activity(torch.from_numpy(x))
    assert tact.dtype == torch.uint8
    np.testing.assert_array_equal(tact.numpy().astype(bool), act)
    chunks = eng.active_chunks(tact).numpy()
    np.testing.assert_array_equal(chunks, act[lay.code.reshape(-1) % lay.num_col_tiles])
    np.testing.assert_array_equal(chunks.reshape(-1, 32).any(1), want)


# ---- predicated engine calls equal the unpredicated ones -----------------
def _dense_frontier(ncols, unit, kind, zero, seed=6):
    """A dense x whose active entries lie in a random set of units."""
    rng = np.random.default_rng(seed)
    act = _activity(ncols // unit, kind, seed)
    x = np.full(ncols, zero, np.float32)
    on = np.repeat(act, unit) & (rng.random(ncols) < 0.3)
    x[on] = rng.random(int(on.sum())).astype(np.float32) + 0.5
    return torch.from_numpy(x)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("flavor", ["roll", "planar_free", "planar_bucket"])
def test_router_call_predicated_equals_call(flavor, name, fused):
    if flavor == "roll":
        lay = pack_router(FIXTURES["multi_region"][0]())
        eng = RouterSpMV(lay, tg.SEMIRINGS[name], CPU)
    else:
        lay = pack_planar(PLANAR_FIXTURES["rmat"][0](),
                          deal=flavor.split("_")[1])
        eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    eng.fused = fused
    for kind in FRONTIERS:
        x = _dense_frontier(lay.num_cols, eng.ACT_COLS, kind, 0.0)
        act = eng.activity(x)
        np.testing.assert_array_equal(
            act.numpy().astype(bool),
            (x.numpy().reshape(-1, eng.ACT_COLS) != 0).any(1))
        y = eng.call_predicated(x)
        np.testing.assert_array_equal(y.numpy(), eng(x).numpy(), err_msg=kind)
        s = eng.scatter_predicated(x, act)
        keep = eng.live_chunks(act).bool()
        np.testing.assert_array_equal(s.reshape(-1, 1024)[~keep].numpy(), 0)
        np.testing.assert_array_equal(
            eng.reduce_predicated(s, eng.live_chunks(act)).numpy(),
            eng.reduce(s).numpy())
        np.testing.assert_array_equal(eng.fused_predicated(x, act).numpy(),
                                      eng.fused_spmv(x).numpy())
        if kind == "empty":
            assert not y.any()
    assert not any(eng.launches.values())


@pytest.mark.parametrize("name", ["arithmetic", "logical", "tropical"])
@pytest.mark.parametrize("fixture", ["rmat", "hub_rows", "empty_windows"])
def test_chunked_call_predicated_equals_call(fixture, name):
    semiring = tg.SEMIRINGS[name]
    lay = pack_csr_chunks(CHUNKED_FIXTURES[fixture](), pad_val=semiring.zero,
                          chunk_order="col")
    eng = ChunkedSpMV(lay, semiring, CPU)
    for kind in FRONTIERS:
        x = _dense_frontier(lay.num_cols, 1024, kind, semiring.zero)
        y = eng.call_predicated(x)
        np.testing.assert_array_equal(y.numpy(), eng(x).numpy(), err_msg=kind)
        if kind == "empty":
            assert (y.numpy() == semiring.zero).all()
    assert eng.launches == {"chunked": 0, "chunked_pred": 0}


# ---- the ladder ----------------------------------------------------------
def test_spmspv_ladder_branches(monkeypatch):
    """Unaligned CSC -> COO; an engine by name without a module to share
    -> COO (as in JAX); tropical whose chunked layout is not feasible
    -> the tropical engine; with reuse_from a chunked SpMV engine is not
    shared (SpMSpV packs its own col layout)."""
    g = rmat_csr(3000, 40000, seed=5)
    for engine, graph, want in (("auto", g, "xla"),
                                ("roll", _graph("rmat"), "xla"),
                                ("pallas", _graph("rmat"), "chunked")):
        mod = SpMSpVModule(tg.EngineConfig(engine=engine, device="cpu"))
        mod.set_semiring(tg.LogicalSemiring)
        mod.load_and_format_matrix(csr2csc(graph))
        assert mod.engine_name == want
    spmv = SpMVModule(CPU)
    spmv.set_semiring(tg.TropicalSemiring)
    spmv.load_and_format_matrix(_graph("rmat"))
    mod = SpMSpVModule(CPU)
    mod.set_semiring(tg.TropicalSemiring)
    mod.load_and_format_matrix(csr2csc(_graph("rmat")), reuse_from=spmv)
    assert mod.engine_name == "chunked" and mod.engine is not spmv.engine
    assert mod.engine.col_order and not spmv.engine.col_order
    monkeypatch.setattr(tspmv, "estimate_chunk_layout_gb", lambda c: 3.0)
    mod = SpMSpVModule(tg.EngineConfig(engine="router", device="cpu"))
    mod.set_semiring(tg.TropicalSemiring)
    mod.load_and_format_matrix(csr2csc(_graph("rmat")))
    assert mod.engine_name == "tropical"
    assert isinstance(mod.engine, TropicalSpMV)
