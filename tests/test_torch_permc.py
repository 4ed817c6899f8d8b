"""The port's PERM-C layout and engine on the CPU, against the JAX package.

  * `pack_permc(native=False)` builds JAX's `native=False` layout array
    for array on two RMAT graphs and three hub fixtures; the port's C++
    greedy is bit-identical to its numpy greedy, and a failed g++ build
    raises;
  * the layout invariants of tests/test_permc.py; `permc_stream_rows`
    against a brute-force walk of the runs; the deposit targets against a
    sequential walk of the descriptor stream, and every deposited element
    against the row it came from (PERM-C keeps up to `depth` = 4 cycles of
    a region live in K-rotated slots, so a piece's target must be the
    flush of its own cycle);
  * K11's function, summed run by run through the destination-lane keys
    as the kernel does, against its plain version (K3's, through the
    position-keyed rows), with and without a live-chunk set;
  * fused and split SpMV (plain versions) against JAX `spmv_coo` and the
    float64 oracle, masks included: ANDOR bit-equal, MULADD within
    1e-5 * max|ref| (test_torch_router.py's tolerance, inside the card's
    1e-4 gate); SpMSpV at a 30% tile frontier through K4p fused and K4p
    scatter -> K11p's plain versions;
  * `planar_deal="permc"` through SpMVModule, SpMSpVModule and the apps
    (BFS pull, push and pull_push; PageRank pull) against the JAX apps
    with `engine="xla"`, and SSSP, whose tropical pass 1 packs "free".

Slow: JAX's K11 and K4 fused PERM-C in Pallas interpret mode against the
plain versions, ANDOR, bit for bit.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu.apps import BFS as JaxBFS, PageRank as JaxPageRank
from graphlily_tpu.io.permc_format import pack_permc as jax_pack_permc
from graphlily_tpu.ops.router_pallas import PlanarSpMV as JaxPlanarSpMV

import graphlily_tpu_torch as tg
from graphlily_tpu_torch import native
from graphlily_tpu_torch.apps import BFS, PageRank, SSSP
from graphlily_tpu_torch.io import (rmat_csr, uniform_csr, pack_permc, pack_planar,
                                    pack_tropical, permc_stream_rows,
                                    deposit_targets, csr2csc,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.io.permc_format import _greedy_permc_py
from graphlily_tpu_torch.module import SpMVModule, SpMSpVModule
from graphlily_tpu_torch.ops import PlanarSpMV

from test_torch_fixtures import (hub_columns_csr, hub_page_csr, hub_row_csr,
                                 one_thread, TROPICAL_FIXTURES)
from test_torch_io import to_jax
from test_torch_router import (CPU, MASKS, _assert_matches, _references,
                               _vectors)

GRAPHS = {
    "rmat_4096": lambda: rmat_csr(4096, 60000, seed=3),
    "rmat_32768": lambda: rmat_csr(32768, 90000, seed=7),
    "hub_columns": hub_columns_csr,
    "hub_page": hub_page_csr,
    "hub_row": hub_row_csr,
    # over 700,000 rows: the ladders' chunked layout is infeasible, so
    # engine="auto" and SpMSpV's own ladder pick the planar router
    "wide": lambda: uniform_csr(720896, 720896, 1, seed=1),
}
PACK_GRAPHS = [k for k in GRAPHS if k != "wide"]
SEMIRINGS = ["arithmetic", "logical"]


@functools.cache
def _graph(name):
    return GRAPHS[name]()


@functools.cache
def _layout(name, native_greedy=True):
    return pack_permc(_graph(name), native=native_greedy)


def _assert_same_fields(a, b, where=""):
    """Every field of two layouts equal: arrays in shape, dtype and
    value, nested layouts field by field, scalars exactly."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        label = where + f.name
        if dataclasses.is_dataclass(x):
            _assert_same_fields(x, y, label + ".")
        elif isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), label
            assert x.dtype == y.dtype and x.shape == y.shape, label
            np.testing.assert_array_equal(x, y, err_msg=label)
        else:
            assert x == y, label


@pytest.mark.parametrize("name", PACK_GRAPHS)
def test_pack_permc_matches_jax(name):
    """The port's numpy pack equals JAX's numpy pack, array for array."""
    jlay = jax_pack_permc(to_jax(_graph(name)), native=False)
    _assert_same_fields(_layout(name, False), jlay)


@pytest.mark.parametrize("name", PACK_GRAPHS)
def test_native_greedy_is_bit_identical(name):
    _assert_same_fields(_layout(name, True), _layout(name, False))


def test_native_greedy_pass_two_is_bit_identical():
    """The balanced second pass (prescribed chunks, spaced spills) of the
    two greedies agrees too, on a renumbering that forces spills."""
    lay_args = _greedy_args(_graph("hub_columns"))
    first = _greedy_permc_py(*lay_args)
    rng = np.random.default_rng(3)
    nca = first[4]
    chunk_of = rng.permutation(nca)[first[0]]
    kw = dict(chunk_of=chunk_of, nca_in=nca, spill_cb=16)
    for a, b in zip(_greedy_permc_py(*lay_args, **kw),
                    native.permc_greedy(*lay_args, **kw)):
        np.testing.assert_array_equal(a, b)


def _greedy_args(csr):
    """pack_permc's greedy inputs for `csr` (region height 1024)."""
    work = csr.copy()
    util_round_csr_matrix_dim(work, 1024, 1024)
    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:work.nnz].astype(np.int64)
    order = np.lexsort((cc, rr, cc >> 10))
    rr, cc = rr[order], cc[order]
    nregions = -(-work.num_rows // 1024)
    return (cc >> 10, cc & 127, (cc >> 7) & 7, rr, rr // 1024, rr & 127,
            work.num_cols // 1024, nregions, 4)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A g++ that fails makes the native greedy raise: nothing falls back
    to numpy quietly."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="false failed"):
            pack_permc(_graph("hub_row"))
    finally:
        native.library.cache_clear()


@pytest.mark.parametrize("name", ["rmat_4096", "hub_columns"])
def test_layout_invariants(name):
    csr, lay = _graph(name), _layout(name)
    assert lay.triples is not None and lay.c_end is not None
    assert lay.planes.shape[1] == 0 and lay.c_lo.shape[0] == 0
    assert lay.a_sub is not None and lay.xperm.shape[0] == 0
    # every element lands once: the value stream's mass is conserved
    assert np.isclose(lay.a_vals[lay.a_vals != 0].sum(dtype=np.float64),
                      csr.adj_data[:csr.nnz].sum(dtype=np.float64),
                      rtol=1e-6)
    rh = lay.region_rows // 128
    end, beg = lay.c_end.astype(np.int32), lay.c_beg.astype(np.int32)
    used = end != 0
    assert (end[used] > beg[used] - 1).all()
    assert (lay.c_hi.astype(np.int32) < rh).all()
    # runs of one (chunk, sublane) are disjoint and cover nnz lanes
    run = end > beg
    assert int((end - beg)[run].sum()) == lay.nnz
    assert (lay.c_code[np.nonzero(run)[0]] >= 0).all()


def _run_walk(lay):
    """(q, s, v, hi, beg, end) of every row run, one loop step each."""
    for q, s, v in zip(*np.nonzero(lay.c_end.astype(np.int32)
                                   > lay.c_beg.astype(np.int32))):
        yield (q, s, v, int(lay.c_hi[q, s, v]), int(lay.c_beg[q, s, v]),
               int(lay.c_end[q, s, v]))


@pytest.mark.parametrize("name", ["rmat_4096", "hub_page"])
def test_stream_rows_match_run_walk(name):
    lay = _layout(name)
    want_hi = np.zeros(lay.c_hi.shape, np.int8)
    want_lo = np.zeros(lay.c_hi.shape, np.int8)
    taken = np.zeros(lay.c_hi.shape, bool)
    for q, s, v, hi, beg, end in _run_walk(lay):
        assert not taken[q, s, beg + 1:end + 1].any(), "runs overlap"
        taken[q, s, beg + 1:end + 1] = True
        want_hi[q, s, beg + 1:end + 1] = hi
        want_lo[q, s, beg + 1:end + 1] = v
    hi, lo = permc_stream_rows(lay, block=64)   # several blocks
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)


def _walk_targets(lay) -> np.ndarray:
    """Flush-stream chunk of each deposit piece by walking the descriptor
    stream in order, as the Pallas kernels run it: per step all pieces,
    then all flushes; a flush empties its slot into chunk t*f + q."""
    want = np.full((lay.nsteps, lay.dstep), -1, np.int64)
    pending = {}
    for t in range(lay.nsteps):
        for j in range(lay.rstep):
            w2 = int(lay.rg[t, j, 1])
            if j < lay.dstep and w2 > 0:
                pending.setdefault(w2 & 0xFFF, []).append((t, j))
            elif j >= lay.dstep and w2 < 0:
                chunk = t * lay.f + ((w2 >> 16) & 0xFF)
                for tt, jj in pending.pop(w2 & 0xFFF, []):
                    want[tt, jj] = chunk
    assert not any(pending.values()), "a piece is never flushed"
    return want


@pytest.mark.parametrize("name", ["rmat_4096", "rmat_32768", "hub_columns"])
def test_deposit_targets_follow_own_cycle(name):
    """The targets equal a sequential walk of the descriptors, and every
    deposited element lands at a stream position whose row (c_code, and
    the position-keyed hi/lo of its own cycle's flush) is its own row."""
    csr, lay = _graph(name), _layout(name)
    np.testing.assert_array_equal(
        deposit_targets(lay.rg, lay.dstep, lay.f), _walk_targets(lay))
    w2 = lay.rg[:, lay.dstep:, 1]
    slots = w2[w2 < 0] & 0xFFF
    if name == "rmat_32768":   # slots flushed more than once
        assert len(np.unique(slots)) < len(slots)
    idx = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU).plain_index()
    slot_row = np.full(lay.a_vals.size, -1, np.int64)
    slot_row[lay.el_slot] = csr.row_ids()
    src, dst = idx["src"].numpy(), idx["dst"].numpy()
    assert len(src) == lay.nnz and len(np.unique(dst)) == lay.nnz
    np.testing.assert_array_equal(idx["row"].numpy()[dst], slot_row[src])


def _k11_walk(lay, stream, live=None):
    """K11's function as the kernel computes it: per flushed (and, with
    `live`, live) chunk, each row's run of the flushed accumulator, read
    through the destination-lane keys, added into its row (float64)."""
    y = np.zeros(lay.num_regions * lay.region_rows)
    g = stream.reshape(-1, 8, 128).astype(np.float64)
    for q, s, v, hi, beg, end in _run_walk(lay):
        if live is None or live[q]:
            row = lay.c_code[q] * lay.region_rows + hi * 128 + v
            y[row] += g[q, s, beg + 1:end + 1].sum()
    return y


@pytest.mark.parametrize("live", [False, True], ids=["all", "live"])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_k11_run_sums_match_plain(name, live):
    lay = _layout("rmat_4096")
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    x, _ = _vectors(lay)
    stream = eng.scatter(torch.from_numpy(x))
    flags = None
    if live:
        flags = torch.from_numpy(
            (np.random.default_rng(1).random(lay.nsteps * lay.f) < 0.5)
            .astype(np.uint8))
    got = (eng.reduce(stream) if flags is None
           else eng.reduce_predicated(stream, flags)).numpy()
    want = _k11_walk(lay, stream.numpy(),
                     None if flags is None else flags.numpy())
    if name == "logical":
        np.testing.assert_array_equal(got.astype(np.float64), want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert eng.launches["permc_reduce"] == eng.launches[
        "permc_reduce_pred"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_permc_spmv_matches_jax_and_oracle(name, mask_type, fused):
    csr, lay = _graph("rmat_4096"), _layout("rmat_4096")
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU, mask_type)
    assert eng.permc and eng.chained
    eng.fused = fused
    x, mask = _vectors(lay)
    y = eng(torch.from_numpy(x), torch.from_numpy(mask))
    assert y.shape == (lay.num_rows,)
    _assert_matches(y, *_references(csr, name, x, mask, mask_type), name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("graph", ["rmat_32768", "hub_columns", "hub_row"])
def test_permc_fixtures(graph, name, fused):
    csr, lay = _graph(graph), _layout(graph)
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    eng.fused = fused
    x, mask = _vectors(lay)
    _assert_matches(eng(torch.from_numpy(x)),
                    *_references(csr, name, x, mask, tg.MaskType.NO_MASK),
                    name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_permc_spmspv_tile_frontier(name, fused):
    """At a 30% tile frontier (x zero off the active tiles), SpMSpV
    through K4p fused or K4p scatter -> K11p (plain versions) equals the
    dense product and the oracle."""
    csr, lay = _graph("rmat_32768"), _layout("rmat_32768")
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    eng.fused = fused
    rng = np.random.default_rng(12)
    act = rng.random(lay.num_col_tiles) < 0.3
    x, mask = _vectors(lay)
    x[~np.repeat(act, 1024)] = 0.0
    xt = torch.from_numpy(x)
    y = eng.call_predicated(xt)
    live = eng.live_chunks(eng.activity(xt))
    assert 0 < int(live.sum()) < int((eng.arrays.c_code >= 0).sum())
    np.testing.assert_array_equal(y.numpy(), eng(xt).numpy())
    _assert_matches(y, *_references(csr, name, x, mask, tg.MaskType.NO_MASK),
                    name)


def test_engine_takes_jax_layout():
    """JAX's PERM-C layout (plain numpy) drives the port's engine, with
    the same result as the port's own layout."""
    jlay = jax_pack_permc(to_jax(_graph("hub_columns")), native=False)
    lay = _layout("hub_columns")
    x, _ = _vectors(lay)
    xt = torch.from_numpy(x)
    for name in SEMIRINGS:
        for fused in (True, False):
            a = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
            b = PlanarSpMV(jlay, tg.SEMIRINGS[name], CPU)
            a.fused = b.fused = fused
            np.testing.assert_array_equal(a(xt).numpy(), b(xt).numpy())


def test_pack_planar_dispatches_to_permc():
    csr = _graph("hub_row")
    _assert_same_fields(pack_planar(csr, deal="permc"), _layout("hub_row"))
    # the tropical pass 1's arguments pack "free", as in the JAX package
    _assert_same_fields(pack_planar(csr, deal="permc", hi_pad=-1),
                        pack_planar(csr, deal="free", hi_pad=-1))
    _assert_same_fields(pack_planar(csr, deal="permc", keep_el_stream=True),
                        pack_planar(csr, deal="free", keep_el_stream=True))


@pytest.mark.parametrize("engine,graph", [("router", "rmat_32768"),
                                          ("auto", "wide")])
def test_spmv_module_selects_permc(engine, graph):
    """planar_deal="permc" through SpMVModule: a planar-class graph gets
    the PERM-C layout, by engine="router" or through the "auto" ladder,
    and run() matches the oracle."""
    cfg = tg.EngineConfig(engine=engine, planar_deal="permc", device="cpu")
    mod = SpMVModule(cfg)
    mod.set_semiring(tg.ArithmeticSemiring)
    mod.set_mask_type(tg.MaskType.NO_MASK)
    mod.load_and_format_matrix(_graph(graph))
    assert mod.engine_name == "planar" and mod.engine.permc
    x = np.random.default_rng(5).random(mod.get_num_rows()).astype(
        np.float32)
    mod.send_vector_host_to_device(x)
    mod.run()
    got = mod.send_results_device_to_host().astype(np.float64)
    want = mod.compute_reference_results(x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_spmspv_module_selects_permc():
    """SpMSpVModule packs its own PERM-C layout for a planar-class graph
    (over 700,000 rows: its ladder's chunked layout is infeasible), or
    shares the SpMV module's engine."""
    csr = _graph("wide")
    cfg = tg.EngineConfig(engine="router", planar_deal="permc",
                          device="cpu")
    spmv = SpMVModule(cfg)
    spmv.set_semiring(tg.LogicalSemiring)
    spmv.load_and_format_matrix(csr)
    csc = csr2csc(csr)
    own, shared = SpMSpVModule(cfg), SpMSpVModule(cfg)
    for mod in (own, shared):
        mod.set_semiring(tg.LogicalSemiring)
    own.load_and_format_matrix(csc)
    shared.load_and_format_matrix(csc, reuse_from=spmv)
    assert own.engine_name == "planar" and own.engine.permc
    assert shared.engine is spmv.engine
    idx = np.array([3, 700, 20000], np.int64)
    vals = np.ones(3, np.float32)
    for mod in (own, shared):
        mod.send_vector_host_to_device((idx, vals))
        mod.run()
        sv = mod.send_results_device_to_host()
        n = int(sv.nnz)
        got = np.zeros(mod.get_num_rows())
        got[sv.indices[:n].numpy()] = sv.values[:n].numpy()
        np.testing.assert_array_equal(
            got, mod.compute_reference_results((idx, vals)))


def _hypersparse():
    return _graph("rmat_32768")


@pytest.mark.parametrize("sort", [False, True], ids=["plain", "degree_sorted"])
def test_bfs_matches_jax(sort):
    """BFS pull (fused, split), push and pull_push on PERM-C equal the JAX
    app and the float64 oracle exactly; SpMSpV shares the engine."""
    g = _hypersparse()
    app = BFS(tg.EngineConfig(engine="router", sort_rows_by_degree=sort,
                              device="cpu", planar_deal="permc"))
    app.load_and_format_matrix(g)
    eng = app.SpMV_.engine
    assert app.SpMV_.engine_name == "planar" and eng.permc
    assert app.SpMSpV_.engine is eng
    jax_app = JaxBFS(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    for src in (0, 17):
        want = np.asarray(jax_app.pull(src, 8))
        np.testing.assert_array_equal(want, app.compute_reference_results(
            src, 8))
        runs = {"pull fused": app.pull(src, 8), "push": app.push(src, 8),
                "pull_push": app.pull_push(src, 8, threshold=0.05)}
        eng.fused = False
        runs["pull split"] = app.pull(src, 8)
        runs["push split"] = app.push(src, 8)
        eng.fused = True
        for label, got in runs.items():
            np.testing.assert_array_equal(got, want, err_msg=label)
        assert (want > 0).sum() > 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_pagerank_matches_jax(fused):
    g = _hypersparse()
    app = PageRank(tg.EngineConfig(engine="router", sort_rows_by_degree=True,
                                   device="cpu", planar_deal="permc"))
    app.load_and_format_matrix(g, 0.9)
    assert app.SpMV_.engine.permc
    app.SpMV_.engine.fused = fused
    got = app.pull(0.9, 10)
    jax_app = JaxPageRank(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), 0.9)
    np.testing.assert_allclose(got, np.asarray(jax_app.pull(0.9, 10)),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, app.compute_reference_results(0.9, 10),
                               rtol=1e-5, atol=0)


def test_sssp_packs_free_pass_one():
    """With planar_deal="permc", SSSP's tropical pass 1 packs "free" (the
    JAX package's quiet switch), and the app matches the oracle."""
    build, region_rows, kb = TROPICAL_FIXTURES["multi_region"]
    csr = build()
    permc = pack_tropical(csr, tg.EngineConfig(planar_deal="permc"),
                          region_rows=region_rows, kb=kb)
    free = pack_tropical(csr, tg.EngineConfig(planar_deal="free"),
                         region_rows=region_rows, kb=kb)
    _assert_same_fields(permc, free)
    assert permc.planar.c_end is None
    app = SSSP(tg.EngineConfig(engine="router", planar_deal="permc",
                               device="cpu"))
    app.load_and_format_matrix(csr)
    assert app.SpMV_.engine_name == "tropical"
    np.testing.assert_array_equal(app.pull(0, 6),
                                  app.compute_reference_results(0, 6))


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_andor_bit_equal_to_jax_interpret(fused):
    """JAX's K4 fused PERM-C (fused) and K4 scatter -> K11 (split) in
    Pallas interpret mode give the port's plain versions' ANDOR result bit
    for bit."""
    lay = _layout("rmat_4096")
    x, _ = _vectors(lay)
    x = (x != 0).astype(np.float32)
    jeng = JaxPlanarSpMV(jax_pack_permc(to_jax(_graph("rmat_4096")),
                                       native=False),
                         jg.LogicalSemiring, jg.EngineConfig(interpret=True))
    assert jeng.permc
    jeng.fused = fused
    want = np.asarray(jeng(jnp.asarray(x)))
    eng = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    eng.fused = fused
    got = eng(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.sum() > 0
