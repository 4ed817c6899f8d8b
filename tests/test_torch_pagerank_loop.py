"""PageRank's pull loop on the CPU: one walk an iteration where the engine
adds into a set-up output (the roll and planar routers' fused walk, here
its plain version), the SpMV and then the add elsewhere (the chunked
engine, the COO engine, the split branch). Every path is held to the
float64 oracle and to JAX's `PageRank` (`engine="xla"`) at rtol 1e-5, as
tests/test_torch_apps.py holds the app; `next_inits` grows by
iterations - 1 a pull on the walk and stays 0 elsewhere, and no engine
counts a launch on the CPU.

Graphs: RMAT 3000 / 40k (roll router, chunked engine, COO engine, split
branch) and the hypersparse RMAT 50000 / 150k (planar router, both
deals), seed 5, the app tests' graphs.
"""
import functools

import numpy as np
import pytest

import graphlily_tpu as jg
from graphlily_tpu.apps import PageRank as JaxPageRank

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.apps import PageRank
from graphlily_tpu_torch.io import rmat_csr

from test_torch_fixtures import one_thread  # noqa: F401
from test_torch_io import to_jax

# path -> (graph, EngineConfig arguments, the engine it resolves to, walks)
PATHS = {
    "roll": ("small", {"engine": "router"}, "roll", True),
    "planar_free": ("hypersparse", {"engine": "router"}, "planar", True),
    "planar_bucket": ("hypersparse", {"engine": "router",
                                      "planar_deal": "bucket"}, "planar",
                      True),
    "roll_split": ("small", {"engine": "router"}, "roll", False),
    "chunked": ("small", {"engine": "auto"}, "chunked", False),
    "xla": ("small", {"engine": "xla"}, "xla", False),
}
ITERATIONS = [1, 2, 3, 10]


def _next_inits(app) -> int:
    """The engine's set-ups of a next output; the COO engine ("xla") is no
    object and sets up none."""
    return getattr(app.SpMV_.engine, "next_inits", 0)


@functools.cache
def _graph(name: str):
    return (rmat_csr(3000, 40000, seed=5) if name == "small"
            else rmat_csr(50000, 150000, seed=5))


@functools.cache
def _jax_ranks(graph: str, iterations: int) -> np.ndarray:
    app = JaxPageRank(jg.EngineConfig(engine="xla"))
    app.load_and_format_matrix(to_jax(_graph(graph)), 0.9)
    return np.asarray(app.pull(0.9, iterations))


@functools.cache
def _app(path: str, sort: bool) -> PageRank:
    graph, kw, _, _ = PATHS[path]
    app = PageRank(tg.EngineConfig(device="cpu", sort_rows_by_degree=sort,
                                   **kw))
    app.load_and_format_matrix(_graph(graph), 0.9)
    if path == "roll_split":
        app.SpMV_.engine.fused = False
    return app


@pytest.mark.parametrize("iterations", ITERATIONS)
@pytest.mark.parametrize("sort", [False, True],
                         ids=["plain", "degree_sorted"])
@pytest.mark.parametrize("path", list(PATHS))
def test_pull_matches_oracle_and_jax(path, sort, iterations):
    graph, _, engine, walks = PATHS[path]
    app = _app(path, sort)
    eng = app.SpMV_.engine
    assert app.SpMV_.engine_name == engine
    assert getattr(eng, "walks_into", False) == walks
    inits = _next_inits(app)
    got = app.pull(0.9, iterations)
    assert _next_inits(app) - inits == (iterations - 1 if walks else 0)
    if eng is not None:
        assert not any(eng.launches.values())
        assert "next_inits" not in eng.launches
    want = _jax_ranks(graph, iterations)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(
        got, app.compute_reference_results(0.9, iterations),
        rtol=1e-5, atol=0)


@pytest.mark.parametrize("path", ["roll", "planar_free"])
def test_device_output_is_a_fresh_tensor_each_pull(path):
    """The returned ranks live in buffers of their own pull: a later pull
    leaves them as they were."""
    app = _app(path, False)
    first = app.pull(0.9, 4, device_output=True)
    kept = first.clone()
    second = app.pull(0.9, 4, device_output=True)
    assert first.data_ptr() != second.data_ptr()
    assert bool((first == kept).all()) and bool((first == second).all())
