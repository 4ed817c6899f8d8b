"""The port's PageRank and BFS (pull) against the JAX apps and the float64
oracles, on the CPU (the router's plain PyTorch versions).

Graph: RMAT 3000 vertices / 40k edges, seed 5. The port runs
`engine="router"` (resolved to the roll router) with and without the
degree-sort relabel; JAX runs `engine="xla"`. PageRank must agree within
rtol 1e-5 (fp32 sums in other orders), BFS exactly. Branches of the
engine ladder whose engine is not ported must raise NotImplementedError.
"""
import numpy as np
import pytest

import graphlily_tpu as jg
from graphlily_tpu.apps import BFS as JaxBFS, PageRank as JaxPageRank

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.apps import BFS, PageRank
from graphlily_tpu_torch.io import rmat_csr, uniform_csr
from graphlily_tpu_torch.module import SpMVModule

from test_torch_io import to_jax

SORT = [False, True]


def _graph():
    return rmat_csr(3000, 40000, seed=5)


@pytest.mark.parametrize("engine", ["router", "xla"])
@pytest.mark.parametrize("sort", SORT, ids=["plain", "degree_sorted"])
def test_pagerank_pull_matches(sort, engine):
    g = _graph()
    app = PageRank(tg.EngineConfig(engine=engine, sort_rows_by_degree=sort,
                                   device="cpu"))
    app.load_and_format_matrix(g, 0.9)
    assert app.SpMV_.engine_name == ("roll" if engine == "router" else "xla")
    got = app.pull(0.9, 10)
    jax_app = JaxPageRank(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g), 0.9)
    want = np.asarray(jax_app.pull(0.9, 10))
    want64 = app.compute_reference_results(0.9, 10)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=0)
    if engine == "router":
        assert app.SpMV_.engine.launches == {"fused": 0, "scatter": 0,
                                             "reduce": 0}


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


def test_bfs_push_not_ported():
    app = BFS(tg.EngineConfig(engine="router", device="cpu"))
    app.load_and_format_matrix(_graph())
    with pytest.raises(NotImplementedError, match="SpMSpV"):
        app.push(0, 3)
    with pytest.raises(NotImplementedError, match="SpMSpV"):
        app.pull_push(0, 3)


@pytest.mark.parametrize("engine,semiring,graph,item", [
    ("auto", "arithmetic", _graph, "item 7"),       # small graph: chunked
    ("pallas", "arithmetic", _graph, "item 7"),
    ("router", "tropical", _graph, "item 9"),
    ("auto", "tropical", _graph, "item 7"),         # feasible: chunked
    ("router", "arithmetic",                          # hypersparse: planar
     lambda: uniform_csr(100000, 100000, 2, seed=1), "item 6"),
])
def test_unported_engine_raises(engine, semiring, graph, item):
    mod = SpMVModule(tg.EngineConfig(engine=engine, device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    with pytest.raises(NotImplementedError, match=item):
        mod.load_and_format_matrix(graph())


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
