"""BFS on Graph 500's Kronecker graph (kernel 2), held exactly to the
benchmark's plain reference.

`BFS.pull_push`, `pull` and `push` run on Kronecker graphs drawn by the
benchmark's own generator (`bench_torch/graphs/kronecker.py`) under the
engine settings of the `graph500-s19-k2` configuration: its ladder
("auto", the chunked engine at these sizes) and the planar router, which
that ladder picks at scale 19 (K4 fused and K4p fused in ANDOR mode over
the value-free forms). Their levels must equal, vertex for vertex,
`bench_torch/reference/bfs.py` in float64 (`compare`'s `level_mismatch`
0): levels are small whole numbers, exact in float32, so no tolerance
applies. Each graph also holds a planted path of four vertices, once
isolated, so one key lies in a small component; the others are Graph
500 search keys drawn from the seed.

On the CPU the engines run their plain versions (scales 10-12). On the
card (`gpu` marker; skips without one) the CUDA walks run at scale 16
against the reference computed on the card. Imports no jax, so on the
card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_bfs_graph500.py
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphlily_tpu_torch import EngineConfig
from graphlily_tpu_torch.apps import BFS
from graphlily_tpu_torch.io.matrix import CSRMatrix

from test_torch_fixtures import one_thread

BENCH_DIR = Path(__file__).resolve().parents[1] / "bench_torch"
# the benchmark's loader, and the neighbours that the reference and the
# generator import (graph)
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

import spec  # noqa: E402
from graph import csr as graph_csr, out_degree_sources  # noqa: E402

reference = spec.load_module(BENCH_DIR / "reference" / "bfs.py")
kronecker = spec.load_module(BENCH_DIR / "graphs" / "kronecker.py")
CONFIG = spec.load_json(BENCH_DIR / "configs" / "graph500-s19-k2.json")
TRAFFIC = spec.load_json(BENCH_DIR / "traffic" / "bfs_pull_push.json")
HOPS = CONFIG["iterations"]["bfs"]
CPU = torch.device("cpu")
# the configuration's ladder, and the engine it picks at scale 19
ENGINES = ["auto", "planar"]
GRAPHS = [(10, 1), (11, 7), (12, 2**31 + 977)]   # (scale, seed)
CALLS = [("pull_push", 0.0), ("pull_push", 0.05), ("pull_push", 1.0),
         ("pull", None), ("push", None)]


def _graph(scale: int, seed: int, device: torch.device):
    """(graph, generator, path) of Graph 500's Kronecker graph at `scale`
    with a path of four vertices, isolated before, joined both ways."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    config = copy.deepcopy(CONFIG)
    config["graph"]["scale"] = scale
    g = kronecker.make(config, gen, device)
    lone = np.flatnonzero(np.diff(g.indptr.astype(np.int64)) == 0)
    path = lone[:4].astype(np.int64)
    assert len(path) == 4, "the graph has fewer than four isolated vertices"
    rows = np.concatenate([g.rows(), path[1:], path[:-1]])
    cols = np.concatenate([g.indices.astype(np.int64), path[:-1], path[1:]])
    weights = np.concatenate([g.weights, np.ones(6, np.float32)])
    g = graph_csr(g.num_vertices, *(torch.from_numpy(a).to(device)
                                    for a in (rows, cols, weights)))
    return g, gen, path


def _app(graph, engine: str, device: str) -> BFS:
    n = graph.num_vertices
    csr = CSRMatrix(n, n, graph.weights.copy(), graph.indices.copy(),
                    graph.indptr.copy())
    app = BFS(EngineConfig(**{**CONFIG["engine"], "engine": engine},
                           device=device))
    app.load_and_format_matrix(csr)
    app.send_matrix_host_to_device()
    if engine == "planar":
        eng = app.SpMV_.engine
        assert app.SpMV_.engine_name == "planar"
        assert app.SpMSpV_.engine is eng
        # every stored weight is 1: the forms drop their value streams
        assert eng.entries.vals is None and eng.pred_entries.vals is None
    return app


@pytest.fixture(scope="module")
def built():
    """(graph, app, sources) by (scale, seed, engine), built once: two
    search keys drawn from the seed, then the path's second vertex."""
    cache = {}

    def get(scale, seed, engine):
        key = (scale, seed, engine)
        if key not in cache:
            graph, gen, path = _graph(scale, seed, CPU)
            keys = [int(s) for s in out_degree_sources(graph, 2, gen)]
            cache[key] = (graph, _app(graph, engine, "cpu"),
                          keys + [int(path[1])])
        return cache[key]
    return get


def _call(app, method, threshold, source, hops):
    if method == "pull_push":
        return app.pull_push(source, hops, threshold)
    return getattr(app, method)(source, hops)


def _mismatch(got, graph, sources, hops, device=CPU) -> float:
    want = reference.solve(graph, {"iterations": {"bfs": hops}}, TRAFFIC,
                           sources, "float64", device)
    return reference.compare(got, want, TRAFFIC)["level_mismatch"]


# ---- on the CPU ---------------------------------------------------------

@pytest.mark.parametrize("method,threshold", CALLS,
                         ids=[f"{m}-{t}" for m, t in CALLS])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scale,seed", GRAPHS,
                         ids=[f"s{s}-{d}" for s, d in GRAPHS])
def test_levels_match_the_reference(built, scale, seed, engine, method,
                                    threshold):
    """Two Graph 500 keys and a key in the planted path: every level
    equal to the float64 reference's. The path's key reaches its three
    neighbours along the path only."""
    graph, app, sources = built(scale, seed, engine)
    n = graph.num_vertices
    got = [np.asarray(_call(app, method, threshold, s, HOPS))[:n]
           for s in sources]
    assert _mismatch(got, graph, sources, HOPS) == 0
    small = got[-1]
    assert sorted(small[small != 0].tolist()) == [1.0, 2.0, 2.0, 3.0]


@pytest.mark.parametrize("method,threshold", CALLS,
                         ids=[f"{m}-{t}" for m, t in CALLS])
@pytest.mark.parametrize("engine", ENGINES)
def test_a_hop_limit_short_of_the_depth_matches_the_reference(
        built, engine, method, threshold):
    """Stopped one hop short of the deepest level a full search reaches,
    the app leaves that level's vertices at 0, as the reference does."""
    graph, app, sources = built(*GRAPHS[0], engine)
    n = graph.num_vertices
    source = sources[0]
    full = np.asarray(_call(app, method, threshold, source, HOPS))[:n]
    depth = int(full.max())
    assert 3 <= depth and depth - 1 < HOPS
    got = np.asarray(_call(app, method, threshold, source, depth - 2))[:n]
    assert _mismatch([got], graph, [source], depth - 2) == 0
    assert got.max() == depth - 1
    assert np.count_nonzero(got != full) == np.count_nonzero(full == depth)


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_pull_push_walks_on_the_card_match_the_reference(cuda, engine):
    """Scale 16 (65,536 vertices, 2.1M entries; "auto" resolves to the
    roll router there, "planar" is the scale-19 engine): the CUDA walks,
    one a hop, levels equal to the reference's on the card."""
    graph, gen, path = _graph(16, 2**31 + 977, cuda)
    app = _app(graph, engine, "cuda")
    eng = app.SpMV_.engine
    assert app.SpMV_.engine_name == {"auto": "roll"}.get(engine, engine)
    sources = [int(s) for s in out_degree_sources(graph, 4, gen)]
    sources.append(int(path[1]))
    got = []
    for s in sources:
        d = app.pull_push(s, HOPS, TRAFFIC["threshold"], device_output=True)
        assert d.is_cuda
        got.append(app._external(d.cpu().numpy())[:graph.num_vertices])
    assert eng.launches["fused"] + eng.launches["fused_pred"] == (
        HOPS * len(sources))
    assert eng.launches["fused_pred"] >= len(sources)
    assert _mismatch(got, graph, sources, HOPS, cuda) == 0
