"""The glue spans of BFS on the router engines (`router.activity`,
`router.epilogue`, `bfs.assign`; `graphlily_tpu_torch/utils/profiling`),
which the benchmark's `ops.bfs_glue_ms` and `ops.bfs_glue_launches` read.

Under `torch.profiler.profile(activities=[CPU])`, on the roll and planar
engines' plain versions: a BFS pull_push records one `router.activity`
a push step, one `router.epilogue` a walk (the ANDOR clamp runs after
every walk) and one `bfs.assign` a level stamp and a push step's count,
and answers as unprofiled; a PageRank pull (MULADD, no mask) records
none of the three.

    python -m pytest tests/test_torch_bfs_glue_spans.py -q
"""
import collections

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from graphlily_tpu_torch import EngineConfig
from graphlily_tpu_torch.apps import BFS, PageRank
from graphlily_tpu_torch.io import rmat_csr

from test_torch_fixtures import one_thread

GLUE = ("router.activity", "router.epilogue", "bfs.assign")
HOPS = 6


def _app(app_cls, engine):
    app = app_cls(EngineConfig(engine=engine, device="cpu"))
    app.load_and_format_matrix(rmat_csr(3000, 40000, seed=5))
    return app


def _span_counts(fn):
    """(fn's result, the number of each glue span it records)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = collections.Counter(e.name for e in prof.events())
    return out, {name: names[name] for name in GLUE}


@pytest.mark.parametrize("threshold", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("engine", ["roll", "planar"])
def test_bfs_pull_push_records_the_glue_spans(engine, threshold,
                                              monkeypatch):
    app = _app(BFS, engine)
    want = app.pull_push(3, HOPS, threshold)
    pushes = [0]
    apply_dense = app.SpMSpV_.apply_dense

    def counted(*args, **kw):
        pushes[0] += 1
        return apply_dense(*args, **kw)

    monkeypatch.setattr(app.SpMSpV_, "apply_dense", counted)
    got, counts = _span_counts(lambda: app.pull_push(3, HOPS, threshold))
    n_push = pushes[0]
    assert n_push == {0.0: 1, 1.0: HOPS - 1}.get(threshold, n_push)
    assert counts == {"router.activity": n_push, "router.epilogue": HOPS,
                      "bfs.assign": HOPS + n_push}
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["roll", "planar"])
def test_pagerank_pull_records_no_glue_span(engine):
    app = _app(PageRank, engine)
    _, counts = _span_counts(lambda: app.pull(0.9, 5))
    assert counts == dict.fromkeys(GLUE, 0)
