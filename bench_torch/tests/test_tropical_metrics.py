"""The readers of the tropical engine's walk and glue
(`kernels.tropical_walk_roofline`, `ops.tropical_glue_ms`,
`ops.tropical_glue_launches`) on hand-made Chrome-trace events.

    python -m pytest bench_torch/tests -q
"""
from __future__ import annotations

import types
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]

import spec  # noqa: E402
from bounds import mv_bound  # noqa: E402
from trace import Trace  # noqa: E402

NAMES = ["kernels.tropical_walk_roofline", "ops.tropical_glue_ms",
         "ops.tropical_glue_launches"]
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
GRAPH = types.SimpleNamespace(num_vertices=524288, nnz=16777216)


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


def _query(t0, walk_us=20.0):
    """One SSSP query from `t0` on the tropical engine: a push step (the
    activity 10-16 with three launches, the predicated walk 20-26 with
    its zeroing and kernel, the decode 28-31 with one launch) and a pull
    step (the walk 40-46 with its zeroing and kernel, the decode 50-53
    with one launch); the harness waits 200-210. The full walk's two
    device operations take 2 us and `walk_us` - 2."""
    c = t0 * 100
    return [
        _span("bench.query", t0, 100),
        _span("tropical.activity", t0 + 10, 6),
        _launch(t0 + 11, c + 1), _launch(t0 + 12, c + 2),
        _launch(t0 + 13, c + 3),
        _span("ops.tropical.fused_pred", t0 + 20, 6),
        _launch(t0 + 21, c + 4), _launch(t0 + 22, c + 5),
        _span("tropical.decode", t0 + 28, 3),
        _launch(t0 + 29, c + 6),
        _span("ops.tropical.fused", t0 + 40, 6),
        _launch(t0 + 41, c + 7), _launch(t0 + 42, c + 8),
        _span("tropical.decode", t0 + 50, 3),
        _launch(t0 + 51, c + 9),
        _span("bench.sync", t0 + 200, 10),
        *[_ev("kernel", f"glue{i}", t0 + 100 + i, 1, corr=c + i)
          for i in (1, 2, 3, 6, 9)],
        _ev("gpu_memset", "zero_pred", t0 + 110, 1, corr=c + 4),
        _ev("kernel", "walk_pred", t0 + 112, 30, corr=c + 5),
        _ev("gpu_memset", "zero", t0 + 150, 2, corr=c + 7),
        _ev("kernel", "walk", t0 + 153, walk_us - 2, corr=c + 8),
    ]


TWO = _query(0) + _query(1000)


def test_glue_ms_is_the_union_of_the_glue_spans_per_query():
    # activity 6 + decode 3 + decode 3 us a query
    assert _read("ops.tropical_glue_ms", TWO) == pytest.approx(12e-3)


def test_overlapping_glue_spans_count_once():
    ev = _query(0) + [_span("tropical.decode", 12, 6)]   # 12-18 over 10-16
    assert _read("ops.tropical_glue_ms", ev) == pytest.approx(14e-3)


def test_glue_launches_count_the_device_operations_in_the_glue():
    # three of the activity, one of each decode; the walks' are left out
    assert _read("ops.tropical_glue_launches", TWO) == pytest.approx(5.0)


def _least_us():
    nbytes, ops = mv_bound(GRAPH.num_vertices, GRAPH.num_vertices, GRAPH.nnz)
    return 1e6 * max(nbytes / PEAKS["hbm_bytes_per_s"],
                     ops / PEAKS["fp32_flops_per_s"])


def test_roofline_reads_the_full_walks_only():
    """The zeroing and the kernel of each full walk, 20 us a walk; the
    predicated walk is left out."""
    assert _read("kernels.tropical_walk_roofline", TWO) == pytest.approx(
        100.0 * _least_us() / 20.0)


def test_roofline_of_a_walk_at_the_bound_reads_100():
    ev = _query(0, walk_us=_least_us()) + _query(1000, walk_us=_least_us())
    assert _read("kernels.tropical_walk_roofline", ev) == pytest.approx(100.0)


def test_roofline_needs_the_cards_peaks():
    assert _read("kernels.tropical_walk_roofline", TWO, peaks=None) is None


def test_spans_outside_the_slice_are_ignored():
    outside = [_span("tropical.decode", -500, 40),
               _span("ops.tropical.fused", -400, 30),
               _launch(-399, 77), _ev("kernel", "walk", -390, 50, corr=77),
               _span("tropical.activity", 5000, 20)]
    for name in NAMES:
        assert _read(name, TWO + outside) == pytest.approx(_read(name, TWO))


# the spans each reader reads
OWN = {"kernels.tropical_walk_roofline": ("ops.tropical.fused",),
       "ops.tropical_glue_ms": ("tropical.activity", "tropical.decode"),
       "ops.tropical_glue_launches": ("tropical.activity", "tropical.decode")}


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(name):
    """No trace, no queries, or none of the reader's own spans (a program
    without the glue spans, a trace with no full walk): None."""
    assert _reader(name).read(types.SimpleNamespace(
        trace=None, peaks=PEAKS, graph=GRAPH)) is None
    assert _read(name, []) is None
    others = [e for e in TWO if e["name"] not in OWN[name]]
    assert _read(name, others) is None
