"""The port's PageRank, BFS and SSSP (pull, push, pull_push) against the
JAX apps and the float64 oracles, on the CPU (the engines' plain PyTorch
versions).

Graphs: RMAT 3000 vertices / 40k edges, seed 5, which `engine="router"`
resolves to the roll router and `engine="auto"` (under 2M edges) to the
chunked engine, and the hypersparse RMAT 50000 / 150k, seed 5, which
`engine="router"` resolves to the planar router (both deals). The port
runs with and without the degree-sort relabel; JAX runs `engine="xla"`.
PageRank must agree within rtol 1e-5 (fp32 sums in other orders), BFS and
SSSP (unit weights: integer distances) exactly. The ladder branch that
raised while its engine was not ported (the tropical engine) now builds
it and matches the oracle.
"""
import functools

import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu.apps import (BFS as JaxBFS, PageRank as JaxPageRank,
                                SSSP as JaxSSSP)

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.apps import BFS, PageRank, SSSP
from graphlily_tpu_torch.io import rmat_csr, uniform_csr
from graphlily_tpu_torch.module import SpMVModule

from test_torch_fixtures import one_thread
from test_torch_io import to_jax

SORT = [False, True]
DEALS = ["free", "bucket"]


def _graph():
    return rmat_csr(3000, 40000, seed=5)


def _hypersparse_graph():
    return rmat_csr(50000, 150000, seed=5)


RESOLVES = {"router": "roll", "xla": "xla", "auto": "chunked"}


@pytest.mark.parametrize("engine", ["router", "xla", "auto"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_pagerank_pull_matches(sort, engine):
    g = _graph()
    app = PageRank(tg.EngineConfig(engine=engine, sort_rows_by_degree=sort,
                                   device="cpu"))
    app.load_and_format_matrix(g, 0.9)
    assert app.SpMV_.engine_name == RESOLVES[engine]
    got = app.pull(0.9, 10)
    jax_app = JaxPageRank(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), 0.9)
    want = np.asarray(jax_app.pull(0.9, 10))
    want64 = app.compute_reference_results(0.9, 10)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=0)
    if engine == "router":
        assert app.SpMV_.engine.launches == {
            "fused": 0, "scatter": 0, "reduce": 0, "fused_pred": 0,
            "scatter_pred": 0, "reduce_pred": 0}
    if engine == "auto":
        assert app.SpMV_.engine.launches == {"chunked": 0, "chunked_pred": 0}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_bfs_pull_matches(sort, fused):
    g = _graph()
    app = BFS(tg.EngineConfig(engine="router", sort_rows_by_degree=sort,
                              device="cpu"))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == "roll"
    app.SpMV_.engine.fused = fused
    jax_app = JaxBFS(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    for src in (0, 17):
        got = app.pull(src, 6)
        np.testing.assert_array_equal(got, np.asarray(jax_app.pull(src, 6)))
        np.testing.assert_array_equal(got, app.compute_reference_results(
            src, 6))
        assert (got > 0).sum() > 1


@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_bfs_pull_chunked_matches(sort):
    """Under 2M edges the auto ladder picks the chunked engine."""
    g = _graph()
    app = BFS(tg.EngineConfig(sort_rows_by_degree=sort, device="cpu"))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == "chunked"
    jax_app = JaxBFS(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    for src in (0, 17):
        got = app.pull(src, 6)
        np.testing.assert_array_equal(got, np.asarray(jax_app.pull(src, 6)))
        np.testing.assert_array_equal(got, app.compute_reference_results(
            src, 6))
        assert (got > 0).sum() > 1


@pytest.mark.parametrize("engine", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_sssp_pull_matches(sort, engine):
    g = _graph()
    app = SSSP(tg.EngineConfig(engine=engine, sort_rows_by_degree=sort,
                               device="cpu"))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == ("xla" if engine == "xla" else "chunked")
    jax_app = JaxSSSP(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    for src in (0, 17):
        got = app.pull(src, 6)
        assert got.dtype == np.float32 and got.shape == (app.matrix_num_rows_,)
        np.testing.assert_array_equal(got, np.asarray(jax_app.pull(src, 6)))
        np.testing.assert_array_equal(got, app.compute_reference_results(
            src, 6))
        reached = got < tg.FLOAT_INF
        assert 1 < reached.sum() < g.num_rows
    if engine != "xla":
        assert app.SpMV_.engine.launches == {"chunked": 0, "chunked_pred": 0}


def test_sssp_weighted_pull_matches():
    """unit_weights=False keeps the graph's weights: SSSP equals the JAX
    app bit for bit and the float64 oracle within fp32 rounding."""
    g = _graph()
    app = SSSP(tg.EngineConfig(device="cpu"))
    app.load_and_format_matrix(g, unit_weights=False)
    jax_app = JaxSSSP(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), unit_weights=False)
    got = app.pull(3, 5)
    np.testing.assert_array_equal(got, np.asarray(jax_app.pull(3, 5)))
    np.testing.assert_allclose(got, app.compute_reference_results(3, 5),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine,semiring,graph,item", [
    ("router", "tropical", _graph, "item 9"),
])
def test_unported_engine_raises(engine, semiring, graph, item):
    """The branch that raised naming its ROADMAP item until that item was
    ported (item 9: engine="router" with the tropical semiring) builds the
    tropical engine and equals the float64 oracle; nothing raises."""
    del item
    mod = SpMVModule(tg.EngineConfig(engine=engine, device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.load_and_format_matrix(graph())
    assert mod.engine_name == "tropical"
    x = np.random.default_rng(3).integers(0, 100, mod.get_num_cols()).astype(
        np.float32)
    np.testing.assert_array_equal(   # the oracle rounded to float32
        mod.apply(torch.from_numpy(x)).numpy(),
        mod.compute_reference_results(x).astype(np.float32))


@pytest.mark.parametrize("engine,semiring", [
    ("auto", "arithmetic"),       # small graph: chunked
    ("pallas", "arithmetic"),     # the chunked engine by name
    ("auto", "tropical"),         # feasible tropical: chunked
    ("auto", "logical"),
])
def test_small_graph_resolves_to_chunked_and_runs(engine, semiring):
    """The graphs whose chunked branch raised before the chunked port now
    resolve to the chunked engine and match the float64 oracle."""
    mod = SpMVModule(tg.EngineConfig(engine=engine, device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.load_and_format_matrix(_graph())
    assert mod.engine_name == "chunked"
    x = np.random.default_rng(4).random(mod.get_num_cols()).astype(
        np.float32)
    mod.send_vector_host_to_device(x)
    mod.run()
    got = mod.send_results_device_to_host().astype(np.float64)
    want = mod.compute_reference_results(x)
    if semiring == "arithmetic":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    elif semiring == "logical":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-23, atol=0)


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("semiring", ["arithmetic", "logical"])
def test_hypersparse_graph_resolves_to_planar_and_runs(semiring, deal):
    """The graph whose planar branch raised before the planar port now
    resolves to the planar engine and matches the float64 oracle."""
    g = uniform_csr(100000, 100000, 2, seed=1)
    mod = SpMVModule(tg.EngineConfig(engine="router", device="cpu",
                                     planar_deal=deal))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.load_and_format_matrix(g)
    assert mod.engine_name == "planar"
    assert mod.engine.chained == (deal == "free")
    x = np.random.default_rng(4).random(mod.get_num_cols()).astype(
        np.float32)
    mod.send_vector_host_to_device(x)
    mod.run()
    got = mod.send_results_device_to_host().astype(np.float64)
    want = mod.compute_reference_results(x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("engine,graph", [
    ("planar", _graph),                 # epg >= 200 would pick roll
    ("roll", _hypersparse_graph),       # epg < 200 would pick planar
])
def test_router_flavor_by_name(engine, graph):
    """As in the JAX package, engine="roll" or "planar" skips the flavor
    rule."""
    g = graph()
    mod = SpMVModule(tg.EngineConfig(engine=engine, device="cpu"))
    mod.set_semiring(tg.ArithmeticSemiring)
    mod.load_and_format_matrix(g)
    assert mod.engine_name == engine
    x = np.random.default_rng(6).random(mod.get_num_cols()).astype(
        np.float32)
    got = mod.apply(torch.from_numpy(x)).numpy().astype(np.float64)
    want = mod.compute_reference_results(x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_planar_pagerank_pull_matches(sort, deal):
    g = _hypersparse_graph()
    app = PageRank(tg.EngineConfig(engine="router", sort_rows_by_degree=sort,
                                   device="cpu", planar_deal=deal))
    app.load_and_format_matrix(g, 0.9)
    assert app.SpMV_.engine_name == "planar"
    got = app.pull(0.9, 10)
    jax_app = JaxPageRank(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), 0.9)
    want = np.asarray(jax_app.pull(0.9, 10))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, app.compute_reference_results(0.9, 10),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_planar_bfs_pull_matches(sort, fused, deal):
    g = _hypersparse_graph()
    app = BFS(tg.EngineConfig(engine="router", sort_rows_by_degree=sort,
                              device="cpu", planar_deal=deal))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == "planar"
    app.SpMV_.engine.fused = fused
    jax_app = JaxBFS(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    for src in (0, 17):
        got = app.pull(src, 8)
        np.testing.assert_array_equal(got, np.asarray(jax_app.pull(src, 8)))
        np.testing.assert_array_equal(got, app.compute_reference_results(
            src, 8))
        assert (got > 0).sum() > 1


def test_module_chained_run():
    """send / bind / run / read back through DeviceBuffers, as the
    reference call sequence does."""
    g = _graph()
    mod = SpMVModule(tg.EngineConfig(engine="router", device="cpu"))
    mod.set_semiring(tg.LogicalSemiring)
    mod.set_mask_type(tg.MaskType.WRITE_TO_ZERO)
    mod.load_and_format_matrix(g)
    rng = np.random.default_rng(9)
    x = (rng.random(g.num_cols) < 0.2).astype(np.float32)
    mask = (rng.random(g.num_rows) < 0.5).astype(np.float32)
    mod.send_vector_host_to_device(x)
    mod.send_mask_host_to_device(mask)
    mod.run()
    got = mod.send_results_device_to_host()
    assert got.shape == (mod.get_num_rows(),)
    np.testing.assert_array_equal(got, mod.compute_reference_results(
        np.pad(x, (0, mod.get_num_cols() - len(x))),
        np.pad(mask, (0, mod.get_num_rows() - len(mask)))))


# ---- push and pull_push (SpMSpV) ---------------------------------------------
# engine case -> (graph, config engine, planar deal, fused, SpMSpV engine)
PUSH_CASES = {
    "roll-fused": (_graph, "router", "free", True, "roll"),
    "roll-split": (_graph, "router", "free", False, "roll"),
    "planar-fused": (_hypersparse_graph, "router", "free", True, "planar"),
    "planar-split": (_hypersparse_graph, "router", "free", False, "planar"),
    "planar_bucket-fused": (_hypersparse_graph, "router", "bucket", True,
                            "planar"),
    "chunked": (_graph, "auto", "free", True, "chunked"),
}


@functools.cache
def _jax_app(cls, graph):
    app = cls(jg.EngineConfig(engine="xla"))
    app.load_and_format_matrix(to_jax(graph()))
    return app


@pytest.mark.parametrize("case", list(PUSH_CASES))
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_bfs_push_and_pull_push_match(sort, case):
    """push, chained push and pull_push (thresholds 0.05, 0 and 1, and one
    iteration) equal the JAX app and the float64 oracle exactly; the
    SpMSpV module shares the SpMV module's router engine."""
    graph, engine, deal, fused, want_engine = PUSH_CASES[case]
    app = BFS(tg.EngineConfig(engine=engine, sort_rows_by_degree=sort,
                              device="cpu", planar_deal=deal))
    app.load_and_format_matrix(graph())
    app.SpMV_.engine.fused = fused
    assert app.SpMSpV_.engine_name == want_engine
    if want_engine == "chunked":
        assert app.SpMSpV_.engine is not app.SpMV_.engine
        assert app.SpMSpV_.engine.col_order
    else:
        assert app.SpMSpV_.engine is app.SpMV_.engine
    jax_app = _jax_app(JaxBFS, graph)
    iters = 8 if graph is _hypersparse_graph else 6
    for src in (0, 17):
        want = app.compute_reference_results(src, iters)
        runs = {
            "push": (app.push(src, iters), jax_app.push(src, iters)),
            "push chained": (app.push(src, iters, chained=True),
                             jax_app.push(src, iters, chained=True)),
            "pull_push": (app.pull_push(src, iters),
                          jax_app.pull_push(src, iters)),
        }
        for th in (0.0, 1.0):
            runs[f"pull_push {th}"] = (app.pull_push(src, iters, th),
                                       jax_app.pull_push(src, iters, th))
        for label, (got, jax_got) in runs.items():
            np.testing.assert_array_equal(got, np.asarray(jax_got),
                                          err_msg=label)
            np.testing.assert_array_equal(got, want, err_msg=label)
        one = app.compute_reference_results(src, 1)
        np.testing.assert_array_equal(app.push(src, 1), one)
        np.testing.assert_array_equal(app.pull_push(src, 1), one)
        assert (want > 0).sum() > 1
    assert not any(app.SpMSpV_.engine.launches.values())


@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_sssp_push_and_pull_push_match(sort, engine):
    """push and pull_push (thresholds 0.05, 0 and 1, and one iteration)
    equal the JAX app and the float64 oracle exactly; on the chunked
    engine SpMSpV packs its own chunk_order="col" layout (K7p)."""
    app = SSSP(tg.EngineConfig(engine=engine, sort_rows_by_degree=sort,
                               device="cpu"))
    app.load_and_format_matrix(_graph())
    want_engine = "xla" if engine == "xla" else "chunked"
    assert app.SpMSpV_.engine_name == want_engine
    if want_engine == "chunked":
        assert app.SpMSpV_.engine.col_order
        assert app.SpMSpV_.engine is not app.SpMV_.engine
    jax_app = _jax_app(JaxSSSP, _graph)
    for src in (0, 17):
        want = app.compute_reference_results(src, 6)
        runs = {"push": (app.push(src, 6), jax_app.push(src, 6)),
                "pull_push": (app.pull_push(src, 6),
                              jax_app.pull_push(src, 6))}
        for th in (0.0, 1.0):
            runs[f"pull_push {th}"] = (app.pull_push(src, 6, th),
                                       jax_app.pull_push(src, 6, th))
        for label, (got, jax_got) in runs.items():
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, np.asarray(jax_got),
                                          err_msg=label)
            np.testing.assert_array_equal(got, want, err_msg=label)
        np.testing.assert_array_equal(app.push(src, 1),
                                      app.compute_reference_results(src, 1))
        reached = want < tg.FLOAT_INF
        assert 1 < reached.sum() < app.matrix_num_rows_


def test_sssp_weighted_push_matches():
    """unit_weights=False: push and pull_push equal the JAX app bit for bit
    and the float64 oracle within fp32 rounding."""
    g = _graph()
    app = SSSP(tg.EngineConfig(device="cpu"))
    app.load_and_format_matrix(g, unit_weights=False)
    jax_app = JaxSSSP(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), unit_weights=False)
    for got, want in ((app.push(3, 5), jax_app.push(3, 5)),
                      (app.pull_push(3, 5), jax_app.pull_push(3, 5))):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_allclose(got, app.compute_reference_results(3, 5),
                                   rtol=1e-6, atol=0)
