"""The port's spans (`graphlily_tpu_torch/utils/profiling.span`): what a
profiled call records, and what an unprofiled one costs.

On the CPU (the engines' plain versions), under
`torch.profiler.profile(activities=[CPU])`: pull_push's step and read
spans follow its iterations, every module span lies inside its query's
app span and every host read inside its push step, and the answer is the
unprofiled call's and the float64 oracle's. Without a profiler `span`
returns one shared object and starts no `record_function`.

On the card (`gpu` marker; skips without one), for each engine: every
`ops.<engine>.<key>` span is one count of `launches[key]`, and each of
the port's own kernels was launched inside one. Imports no jax, so on
the card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py
"""
import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphlily_tpu_torch import (ArithmeticSemiring, LogicalSemiring,
                                 TropicalSemiring, EngineConfig)
from graphlily_tpu_torch.apps import BFS, PageRank, SSSP
from graphlily_tpu_torch.io import (rmat_csr, pack_router, pack_planar,
                                    pack_permc, pack_csr_chunks,
                                    pack_tropical)
from graphlily_tpu_torch.ops import (RouterSpMV, PlanarSpMV, ChunkedSpMV,
                                     TropicalStages)
from graphlily_tpu_torch.utils import profiling

from test_torch_fixtures import one_thread

# the port's kernels (csrc/*.cu), as the trace names them
KERNELS = ("chunked_spmv_kernel", "permc_reduce_pred_kernel",
           "planar_store_kernel", "planar_xperm_kernel",
           "router_fused_kernel", "router_reduce_kernel",
           "router_reduce_pred_kernel", "router_scatter_kernel",
           "split_pieces_kernel", "split_triples_kernel",
           "window_reduce_kernel")
# the launch counters each engine's calls below move
KEYS = {
    "roll": {"fused", "fused_pred", "scatter", "scatter_pred", "reduce",
             "reduce_pred"},
    "planar": {"fused", "fused_pred", "scatter", "scatter_pred", "reduce",
               "reduce_pred", "xperm"},
    "permc": {"fused", "fused_pred", "scatter", "scatter_pred",
              "permc_reduce", "permc_reduce_pred"},
    "chunked": {"chunked", "chunked_pred"},
    "tropical": {"fused", "fused_pred", "scatter", "scatter_pred", "split",
                 "window_reduce"},
}
APP_ROOTS = {"apps.pagerank.pull", "apps.sssp.pull_push",
             "apps.bfs.pull_push"}


def _graph():
    return rmat_csr(3000, 40000, seed=5)


def _app(app_cls):
    app = app_cls(EngineConfig(device="cpu"))
    app.load_and_format_matrix(_graph())
    return app


def _profiled(fn):
    """(fn's result, the profile's events) on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _count_calls(monkeypatch, module, name):
    """Count the calls of a module method (the push steps)."""
    calls = [0]
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("threshold", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("app_cls", [BFS, SSSP], ids=["bfs", "sssp"])
def test_pull_push_spans_count_steps(app_cls, threshold, monkeypatch):
    """A profiled pull_push records one push step and one host read per
    SpMSpV call (push while it + 1 < n and the frontier is sparse) and a
    pull step for each other iteration, and answers as unprofiled."""
    app = _app(app_cls)
    want = app.pull_push(3, 6, threshold)
    pushes = _count_calls(monkeypatch, app.SpMSpV_, "apply_dense")
    got, events = _profiled(lambda: app.pull_push(3, 6, threshold))
    n_push = pushes[0]
    names = collections.Counter(e.name for e in events)
    assert n_push == {0.0: 1, 1.0: 5}.get(threshold, n_push)
    assert names["apps.push_step"] == n_push
    assert names["apps.pull_step"] == 6 - n_push
    assert names["apps.host_read"] == n_push
    assert names["module.spmspv"] == n_push
    assert names["module.spmv"] == 6 - n_push
    assert names[f"apps.{app_cls.__name__.lower()}.pull_push"] == 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, app.compute_reference_results(3, 6))


def _inside(inner, outers) -> bool:
    return any(o.time_range.start <= inner.time_range.start
               and inner.time_range.end <= o.time_range.end for o in outers)


@pytest.mark.parametrize("app_cls", [PageRank, SSSP, BFS],
                         ids=["pagerank", "sssp", "bfs"])
def test_spans_nest_inside_the_query(app_cls):
    """Every module span and the initial state lie inside the query's app
    span, and every host read inside a push step."""
    app = _app(app_cls)
    if app_cls is PageRank:
        _, events = _profiled(lambda: app.pull(0.9, 5))
    else:
        _, events = _profiled(lambda: app.pull_push(3, 6, 0.05))
    by = collections.defaultdict(list)
    for e in events:
        by[e.name].append(e)
    roots = [e for name in APP_ROOTS for e in by[name]]
    assert len(roots) == 1
    inner = by["module.spmv"] + by["module.spmspv"] + by["apps.init"]
    assert len(by["apps.init"]) == 1 and len(inner) > 1
    assert all(_inside(e, roots) for e in inner)
    assert all(_inside(e, by["apps.push_step"]) for e in by["apps.host_read"])
    if app_cls is not PageRank:
        assert by["apps.host_read"]


def test_span_without_a_profiler_is_one_shared_object(monkeypatch):
    """No profiler: `span` hands out `OFF` and builds no record_function,
    and the app's answer is unchanged."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("apps.init") is profiling.span("x") is profiling.OFF
    made = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: made.append(name))
    app = _app(PageRank)
    got = app.pull(0.9, 5)
    assert made == []
    np.testing.assert_allclose(got, app.compute_reference_results(0.9, 5),
                               rtol=1e-5)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _x(ncols, zero, seed=7):
    """A frontier-like x >= 0 with 30% of its entries the semiring zero."""
    rng = np.random.default_rng(seed)
    x = (rng.random(ncols) * 10 + 0.5).astype(np.float32)
    x[rng.random(ncols) < 0.3] = zero
    return torch.from_numpy(x).to("cuda")


def _router_calls(eng, x):
    """K1 and K1p (fused), K2 -> K3 and K2p -> K3p (split)."""
    def run():
        eng.fused = True
        eng(x)
        eng.call_predicated(x)
        eng.fused = False
        eng(x)
        eng.call_predicated(x)
    return run


def _engine(name):
    """(engine, a call that launches each of its app-path kernels)."""
    card = EngineConfig(device="cuda")
    if name == "roll":
        eng = RouterSpMV(pack_router(_graph()), ArithmeticSemiring, card)
        return eng, _router_calls(eng, _x(eng.num_cols, 0.0))
    if name in ("planar", "permc"):
        csr = rmat_csr(9000, 60000, seed=3)
        lay = (pack_permc(csr) if name == "permc"
               else pack_planar(csr, deal="bucket"))
        eng = PlanarSpMV(lay, LogicalSemiring, card)
        x = _x(eng.num_cols, 0.0)
        calls = _router_calls(eng, x)

        def run():
            calls()
            if name == "planar":
                eng.xperm(x)
        return eng, run
    if name == "chunked":
        eng = ChunkedSpMV(pack_csr_chunks(_graph(), chunk_order="col"),
                          ArithmeticSemiring, card)
        x = _x(eng.num_cols, 0.0)
        return eng, lambda: (eng(x), eng.call_predicated(x))
    csr = rmat_csr(3000, 20000, seed=3)
    stages = TropicalStages(pack_tropical(csr, EngineConfig()), card)
    walk = stages.walk
    x = _x(walk.num_cols, TropicalSemiring.zero)

    def run():
        walk(x)
        walk.call_predicated(x)
        stages.window_reduce(stages.split(stages.scatter(x)))
        stages.scatter_predicated(x, walk.activity(x))
    return stages, run


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(KEYS))
def test_launch_spans_match_counters(name, cuda, tmp_path):
    """Each `ops.<engine>.<key>` span of a profiled call is one count of
    `launches[key]`; each of the port's kernels (not torch's own) was
    launched inside an `ops` span."""
    eng, run = _engine(name)
    run()                                   # builds and loads the kernels
    torch.cuda.synchronize()
    before = dict(eng.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in eng.launches.items()
            if v > before[k]}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    x = [e for e in events if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in x if e.get("cat") == "user_annotation"
             and e["name"].startswith("ops.")]
    engine = {"permc": "planar"}.get(name, name)
    counted = collections.Counter(n for _, _, n in spans)
    assert counted == {f"ops.{engine}.{k}": v for k, v in grew.items()}
    assert set(grew) == KEYS[name]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in x
                 if e.get("cat", "").startswith("cuda_")
                 and "correlation" in e.get("args", {})}
    ours = [e for e in x if e.get("cat") == "kernel"
            and any(k in e["name"] for k in KERNELS)]
    assert ours
    for e in ours:
        t = launch_ts[e["args"]["correlation"]]
        assert any(s <= t <= end for s, end, _ in spans), e["name"]
