"""Weighted SSSP on the tropical engine, held to the benchmark's plain
reference, and the tropical packer's refusal of negative stored values.

`SSSP.pull_push(src, 11, 0.05)` runs on Graph 500 Kronecker graphs drawn
by the benchmark's own generator (`bench_torch/graphs/kronecker.py`,
weights U[0, 1)), with `engine="router"`, so that ADDMIN resolves to the
tropical engine for SpMV and SpMSpV alike: the walk (K4 fused ADDMIN)
for pull steps, the predicated walk (K4p fused ADDMIN) for push steps.
Its distances are compared with `bench_torch/reference/sssp.py` (plain
float64 torch, hop-limited Bellman-Ford) by the reference's own
`compare`: the vertices reached must be the same, and each distance
within 11 * 2**-23 of the reference's, relatively. Each of the 11 hops
adds at most one float32 rounding (2**-24 relative) to a path's sum, and
a min of rounded sums is within the largest rounding of the sums; the
bound leaves a factor of two. The same reference computed in TF32 reads
about 1e-3 there.

On the CPU the engines run their plain versions (scales 10-12, 3 seeds, 2
sources each). On the card (`gpu` marker; skips without one) the CUDA
walks run at scale 16 against the reference computed on the card, 11
walks a query. F2 (ROADMAP queue 3): `pack_tropical` raises on the uniform
4,096 x 4,096 graph with every fifth stored value negated.

Imports no jax, so on the card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_sssp_tropical.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphlily_tpu_torch import EngineConfig
from graphlily_tpu_torch.apps import SSSP
from graphlily_tpu_torch.io import csr_from_coo, pack_tropical
from graphlily_tpu_torch.io.matrix import CSRMatrix

from test_torch_fixtures import one_thread

BENCH_DIR = Path(__file__).resolve().parents[1] / "bench_torch"
# the benchmark's loader, and the neighbours that the reference and the
# generator import (precision, graph)
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

import spec  # noqa: E402
from graph import out_degree_sources  # noqa: E402

reference = spec.load_module(BENCH_DIR / "reference" / "sssp.py")
kronecker = spec.load_module(BENCH_DIR / "graphs" / "kronecker.py")
TRAFFIC = spec.load_json(BENCH_DIR / "traffic" / "sssp_pull_push.json")

HOPS = 11
THRESHOLD = 0.05
REL_ERR = HOPS * 2.0**-23
CONFIG = {"iterations": {"sssp": HOPS}}


def _graph(scale: int, seed: int, device: torch.device):
    """(graph, generator) of Graph 500's Kronecker graph at `scale`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    config = {"graph": {"generator": "kronecker", "scale": scale,
                        "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}}
    return kronecker.make(config, gen, device), gen


def _app(graph, device: str) -> SSSP:
    n = graph.num_vertices
    csr = CSRMatrix(n, n, graph.weights.copy(), graph.indices.copy(),
                    graph.indptr.copy())
    app = SSSP(EngineConfig(engine="router", sort_rows_by_degree=True,
                            device=device))
    app.load_and_format_matrix(csr, unit_weights=False)
    app.send_matrix_host_to_device()
    assert app.SpMV_.engine_name == "tropical"
    assert app.SpMSpV_.engine_name == "tropical"
    assert app.SpMSpV_.engine is app.SpMV_.engine
    return app


def _assert_within_reference(got: list, graph, sources, device):
    want = reference.solve(graph, CONFIG, TRAFFIC, sources, "float64", device)
    checks = reference.compare(got, want, TRAFFIC)
    assert checks["reach_mismatch"] == 0, checks
    assert checks["dist_rel_err"] <= REL_ERR, checks


# ---- on the CPU ---------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 2**31 + 977])
@pytest.mark.parametrize("scale", [10, 11, 12])
def test_pull_push_on_the_tropical_engine_matches_the_reference(scale, seed):
    graph, gen = _graph(scale, seed, torch.device("cpu"))
    app = _app(graph, "cpu")
    sources = [int(s) for s in out_degree_sources(graph, 2, gen)]
    got = [app.pull_push(s, HOPS, THRESHOLD)[:graph.num_vertices]
           for s in sources]
    _assert_within_reference(got, graph, sources, torch.device("cpu"))


def _f2_graph() -> CSRMatrix:
    """F2's fixture: a uniform random 4,096 x 4,096 graph, 30,000 draws
    (numpy seed 7), duplicates removed."""
    rng = np.random.default_rng(7)
    n = 4096
    rows = rng.integers(0, n, 30000)
    cols = rng.integers(0, n, 30000)
    vals = rng.random(30000).astype(np.float32)
    _, first = np.unique(rows * n + cols, return_index=True)
    return csr_from_coo(rows[first], cols[first], vals[first], n, n)


@pytest.mark.parametrize("split_format", ["planes", "triples"])
def test_pack_tropical_raises_on_negative_stored_values(split_format):
    """Every fifth stored value negated: the pack raises, where it once
    clipped them to 0 and the engine gave wrong minima on 3,409 of 4,096
    rows; the same graph unnegated packs."""
    g = _f2_graph()
    pack_tropical(g, EngineConfig(), split_format=split_format)
    g.adj_data[:g.nnz:5] *= -1
    negated = len(range(0, g.nnz, 5))
    with pytest.raises(ValueError, match=f"{negated} of {g.nnz} are negative"):
        pack_tropical(g, EngineConfig(), split_format=split_format)


def test_sssp_on_negative_weights_raises_through_the_ladder():
    """The app reaches the packer's refusal on the normal path."""
    g = _f2_graph()
    g.adj_data[:g.nnz:5] *= -1
    app = SSSP(EngineConfig(engine="router", device="cpu"))
    with pytest.raises(ValueError, match="stored values >= 0"):
        app.load_and_format_matrix(g, unit_weights=False)


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pull_push_walks_on_the_card_match_the_reference(cuda):
    """Scale 16 (65,536 vertices, 2.1M entries): the CUDA walks, 11 a
    query and none of the three-pass stages, within the reference."""
    graph, gen = _graph(16, 2**31 + 977, cuda)
    app = _app(graph, "cuda")
    eng = app.SpMV_.engine
    sources = [int(s) for s in out_degree_sources(graph, 4, gen)]
    got = []
    for s in sources:
        d = app.pull_push(s, HOPS, THRESHOLD, device_output=True)
        assert d.is_cuda
        got.append(app._external(d.cpu().numpy())[:graph.num_vertices])
    assert eng.launches["fused"] + eng.launches["fused_pred"] == (
        HOPS * len(sources))
    assert eng.launches["fused_pred"] >= len(sources)
    # the engine is the walk: it counts no other launch and holds no
    # pass-1 store form for the three passes' K4 scatter
    assert set(eng.launches) == {"fused", "fused_pred"}
    assert not hasattr(eng.planar, "store_entries")
    _assert_within_reference(got, graph, sources, cuda)
