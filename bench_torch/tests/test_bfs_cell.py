"""The cell `graph500-s19.bfs` (Graph 500 kernel 2, BFS pull_push) on the
CPU, from its own files, and the readers of its walk and glue
(`kernels.bfs_walk_roofline`, `ops.bfs_glue_ms`,
`ops.bfs_glue_launches`) on hand-made Chrome-trace events.

The runs take the cell's configuration with its graph cut to scale 10,
under the configuration's ladder ("auto": the chunked engine at this
size) and under the planar router by name, the engine the ladder picks
at scale 19 (K4 fused and K4p fused in ANDOR mode, on the card). On the
card the control is read with

    python3 bench_torch/control.py --workload graph500-s19.bfs --seeds 3 5 7

and here with

    python -m pytest bench_torch/tests/test_bfs_cell.py -q
"""
from __future__ import annotations

import copy
import dataclasses
import time
import types
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]

import control  # noqa: E402
from bounds_logical import logical_mv_bytes  # noqa: E402
from faults import FAULTS  # noqa: E402
import graph as graphs  # noqa: E402
import harness  # noqa: E402
import spec  # noqa: E402
from trace import Trace  # noqa: E402

CELL = "graph500-s19.bfs"
CPU = torch.device("cpu")
SEED = 2**31 + 977
SCALE = 10
# the general readers whose lists the cell joins, and its own
GENERAL = ["io.format_s", "apps.syncs_per_query", "apps.host_self_ms",
           "apps.wait_ms", "module.spmv_device_ms", "module.spmspv_device_ms",
           "module.host_self_us", "ops.kernel_calls_per_query",
           "ops.launch_host_us", "device.idle_pct",
           "device.launches_per_query"]
OWN = ["kernels.bfs_walk_roofline", "ops.bfs_glue_ms",
       "ops.bfs_glue_launches"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(engine: str = "auto"):
    """The cell with its configuration's graph at scale 10, on `engine`."""
    cell = spec.load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config["graph"]["scale"] = SCALE
    config["engine"]["engine"] = engine
    return dataclasses.replace(cell, config=config)


def run(cell, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.3, trace, CPU, time.perf_counter())


# ---- the cell's files ----------------------------------------------------

def test_found_by_name():
    from graphlily_tpu_torch.apps import BFS
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "graph500-s19-k2"
    assert cell.config["graph"]["scale"] == 19
    assert cell.config["engine"] == {"dtype": "float32", "engine": "auto",
                                     "sort_rows_by_degree": True,
                                     "planar_deal": "free"}
    assert cell.traffic["entry"] == "bfs_pull_push"
    assert cell.traffic["reference"] == "bfs"
    assert Path(cell.entry.__file__) == BENCH_DIR / "traffic/bfs_pull_push.py"
    assert Path(cell.reference.__file__) == BENCH_DIR / "reference/bfs.py"
    assert cell.entry.ENTRY == (BFS, "pull_push")
    assert (cell.reference.CONTROLS, cell.reference.SOUND) == (
        ("short",), ("float32",))
    assert cell.workload["limits"] == {"level_mismatch": 0}
    names = [m["name"] for m in cell.per_layer]
    assert sorted(names) == sorted(GENERAL + OWN)
    assert "kernels.spmv_roofline" not in names
    assert {m["name"] for m in cell.end_to_end} == {
        "queries_per_s", "query_p95_ms", "setup_s"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("engine", ["auto", "planar"])
def test_tiny_run_is_correct(engine, trace):
    result, lines = run(small_cell(engine), trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"] == {"level_mismatch": {"value": 0.0, "limit": 0}}
    assert lines[-1].startswith("correct: True")
    if trace:   # a program counter; no device number from a CPU run
        assert set(result["metrics"]) == {"ops.kernel_calls_per_query"}


def _sampled(cell, seed):
    """The graph and sample `control.control` draws for `seed`."""
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    g = graphs.make(cell.config, gen, CPU)
    queries = cell.entry.queries(g, cell.config, cell.traffic, gen)
    k = int(cell.traffic["sample"])
    return g, cell.config, cell.traffic, (queries * k)[:k]


@pytest.mark.parametrize("seed", [3, 5, SEED])
def test_short_fails_and_float32_passes(seed):
    """Stopped one hop short of its deepest level, the reference fails
    the exact limit; in float32 it is within it. The deepest level lies
    under the hop limit, so the search is complete."""
    cell = small_cell()
    short, f32 = control.control(cell, seed, ("short", "float32"), CPU)
    assert (short["role"], f32["role"]) == ("control", "sound")
    assert short["checks"]["level_mismatch"] > 0
    assert not all(short["within"].values())
    assert all(f32["within"].values())
    want = cell.reference.solve(*_sampled(cell, seed), "float64", CPU)
    assert max(d.max() for d in want) - 1 < cell.config["iterations"]["bfs"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("engine", ["auto", "planar"])
def test_fault_is_not_correct(engine, fault, monkeypatch):
    cell = small_cell(engine)
    FAULTS[fault](monkeypatch, cell)
    result, _ = run(cell)
    assert result["correct"] is False, result["checks"]


def test_the_walks_form_stores_4_bytes_an_entry():
    """The planar BFS engine's row form drops its value stream (every
    weight is 1): one int32 word for each stored entry, the 4 B an entry
    that `logical_mv_bytes` counts."""
    from graphlily_tpu_torch.apps import BFS
    from graphlily_tpu_torch.config import EngineConfig
    from graphlily_tpu_torch.io.matrix import CSRMatrix
    cell = small_cell("planar")
    g = _sampled(cell, SEED)[0]
    n = g.num_vertices
    app = BFS(EngineConfig(**cell.config["engine"], device="cpu"))
    app.load_and_format_matrix(CSRMatrix(n, n, g.weights.copy(),
                                         g.indices.copy(), g.indptr.copy()))
    e = app.SpMV_.engine.entries
    assert e.vals is None
    assert e.idx.numel() == g.nnz and e.idx.element_size() == 4


# ---- the bound and the readers --------------------------------------------

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
GRAPH = types.SimpleNamespace(num_vertices=524288, nnz=16777216)
GLUE = ("router.activity", "router.epilogue", "bfs.assign")


def test_bound_counts_4_bytes_an_entry():
    n, nnz = GRAPH.num_vertices, GRAPH.nnz
    assert logical_mv_bytes(n, n, nnz + 1) - logical_mv_bytes(n, n, nnz) == 4
    assert logical_mv_bytes(n, n, 0) == 4 * (n + 1) + 4 * n + 4 * n
    # scale 19: about 73.4 MB, 21.9 us at 3.35 TB/s
    assert logical_mv_bytes(n, n, nnz) == 73_400_324
    assert 1e6 * logical_mv_bytes(n, n, nnz) / PEAKS["hbm_bytes_per_s"] == (
        pytest.approx(21.91, abs=0.01))


def _reader(name):
    return spec.load_module(BENCH_DIR / "metrics" / f"{name}.py")


def _read(name, events, peaks=PEAKS):
    return _reader(name).read(types.SimpleNamespace(
        trace=Trace(events), peaks=peaks, graph=GRAPH))


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr)


def _query(t0, walk_us=40.0):
    """One BFS query from `t0` on the planar engine: a push step (the
    activity 10-16 with three launches, the predicated walk 20-26 with
    its zeroing and kernel, the epilogue 28-31 with one launch, the stamp
    and count 32-36 with two) and a pull step (the walk 40-46 with its
    zeroing and kernel, the epilogue 50-54 with two launches, the stamp
    56-58 with one); the harness waits 500-510. The full walk's two
    device operations take 2 us and `walk_us` - 2."""
    c = t0 * 100
    return [
        _span("bench.query", t0, 100),
        _span("router.activity", t0 + 10, 6),
        _launch(t0 + 11, c + 1), _launch(t0 + 12, c + 2),
        _launch(t0 + 13, c + 3),
        _span("ops.planar.fused_pred", t0 + 20, 6),
        _launch(t0 + 21, c + 4), _launch(t0 + 22, c + 5),
        _span("router.epilogue", t0 + 28, 3),
        _launch(t0 + 29, c + 6),
        _span("bfs.assign", t0 + 32, 4),
        _launch(t0 + 33, c + 10), _launch(t0 + 34, c + 11),
        _span("ops.planar.fused", t0 + 40, 6),
        _launch(t0 + 41, c + 7), _launch(t0 + 42, c + 8),
        _span("router.epilogue", t0 + 50, 4),
        _launch(t0 + 51, c + 9), _launch(t0 + 52, c + 12),
        _span("bfs.assign", t0 + 56, 2),
        _launch(t0 + 57, c + 13),
        _span("bench.sync", t0 + 500, 10),
        *[_ev("kernel", f"glue{i}", t0 + 100 + i, 1, corr=c + i)
          for i in (1, 2, 3, 6, 9, 10, 11, 12, 13)],
        _ev("gpu_memset", "zero_pred", t0 + 115, 1, corr=c + 4),
        _ev("kernel", "walk_pred", t0 + 117, 30, corr=c + 5),
        _ev("gpu_memset", "zero", t0 + 150, 2, corr=c + 7),
        _ev("kernel", "walk", t0 + 153, walk_us - 2, corr=c + 8),
    ]


TWO = _query(0) + _query(1000)


def _least_us():
    n, nnz = GRAPH.num_vertices, GRAPH.nnz
    return 1e6 * logical_mv_bytes(n, n, nnz) / PEAKS["hbm_bytes_per_s"]


def test_glue_ms_is_the_union_of_the_glue_spans_per_query():
    # activity 6 + epilogues 3 + 4 + assigns 4 + 2 us a query
    assert _read("ops.bfs_glue_ms", TWO) == pytest.approx(19e-3)


def test_overlapping_glue_spans_count_once():
    ev = _query(0) + [_span("bfs.assign", 12, 6)]   # 12-18 over 10-16
    assert _read("ops.bfs_glue_ms", ev) == pytest.approx(21e-3)


def test_glue_launches_count_the_device_operations_in_the_glue():
    # three of the activity, three of the epilogues, three of the
    # assigns; the walks' are left out
    assert _read("ops.bfs_glue_launches", TWO) == pytest.approx(9.0)


def test_roofline_reads_the_full_walks_only():
    """The zeroing and the kernel of each full walk, 40 us a walk; the
    predicated walk is left out."""
    assert _read("kernels.bfs_walk_roofline", TWO) == pytest.approx(
        100.0 * _least_us() / 40.0)


@pytest.mark.parametrize("slower", [1.0, 1.001, 1.5, 3.0, 10.0])
def test_roofline_never_passes_100_for_a_walk_no_faster_than_the_bound(
        slower):
    """A walk that takes the bound's time reads 100%; a slower one less."""
    walk = _least_us() * slower
    ev = _query(0, walk_us=walk) + _query(1000, walk_us=walk)
    got = _read("kernels.bfs_walk_roofline", ev)
    assert got == pytest.approx(100.0 / slower)
    assert got <= 100.0 + 1e-9


def test_roofline_needs_the_cards_peaks():
    assert _read("kernels.bfs_walk_roofline", TWO, peaks=None) is None


def test_spans_outside_the_slice_are_ignored():
    outside = [_span("router.epilogue", -500, 40),
               _span("ops.planar.fused", -400, 30),
               _launch(-399, 77), _ev("kernel", "walk", -390, 50, corr=77),
               _span("bfs.assign", 5000, 20)]
    for name in OWN:
        assert _read(name, TWO + outside) == pytest.approx(_read(name, TWO))


# the spans each reader reads
SPANS = {"kernels.bfs_walk_roofline": ("ops.planar.fused",),
         "ops.bfs_glue_ms": GLUE, "ops.bfs_glue_launches": GLUE}


@pytest.mark.parametrize("name", OWN)
def test_none_without_spans(name):
    """No trace, no queries, or none of the reader's own spans (a program
    without the glue spans, as before they were added): None, no
    error."""
    assert _reader(name).read(types.SimpleNamespace(
        trace=None, peaks=PEAKS, graph=GRAPH)) is None
    assert _read(name, []) is None
    others = [e for e in TWO if e["name"] not in SPANS[name]]
    assert _read(name, others) is None
