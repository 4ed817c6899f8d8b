"""The readers of the program's own spans (`apps.host_self_ms`,
`module.host_self_us`, `ops.launch_host_us`, `apps.wait_ms`) on
hand-made Chrome-trace events, and the breakdown's idle gaps named by
those spans.

    python -m pytest bench_torch/tests -q
"""
from __future__ import annotations

import types
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]

import spec  # noqa: E402
from trace import Trace  # noqa: E402

NAMES = ["apps.host_self_ms", "module.host_self_us", "ops.launch_host_us",
         "apps.wait_ms"]


def _reader(name):
    return spec.load_module(BENCH_DIR / "metrics" / f"{name}.py")


def _read(name, events):
    return _reader(name).read(types.SimpleNamespace(trace=Trace(events)))


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


def _query(t0):
    """One SSSP query from `t0`: the app span 0-100 holds a push step
    (10-60: a module call 12-40 with a launch 20-30, then a read 45-55)
    and a pull step (62-95: a module call 65-90 with a launch 70-74); the
    harness waits 102-110. The card runs 40-52 and 76-86."""
    return [
        _span("bench.query", t0, 101),
        _span("apps.sssp.pull_push", t0, 100),
        _span("apps.init", t0 + 2, 5),
        _span("apps.push_step", t0 + 10, 50),
        _span("module.spmspv", t0 + 12, 28),
        _span("ops.chunked.chunked_pred", t0 + 20, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", t0 + 25, 2, corr=t0 + 1),
        _span("apps.host_read", t0 + 45, 10),
        _ev("cuda_runtime", "cudaStreamSynchronize", t0 + 46, 8),
        _span("apps.pull_step", t0 + 62, 33),
        _span("module.spmv", t0 + 65, 25),
        _span("ops.chunked.chunked", t0 + 70, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", t0 + 72, 1, corr=t0 + 2),
        _span("bench.sync", t0 + 102, 8),
        _ev("kernel", "k_pred", t0 + 40, 12, corr=t0 + 1),
        _ev("kernel", "k", t0 + 76, 10, corr=t0 + 2),
    ]


TWO = _query(0) + _query(200)


def test_self_time_is_the_span_less_its_children():
    # app: 100 less the module calls (28 + 25) and the read (10)
    assert _read("apps.host_self_ms", TWO) == pytest.approx(37e-3)
    # module calls: (28 - 10) and (25 - 4), per call
    assert _read("module.host_self_us", TWO) == pytest.approx(39 / 2)
    assert _read("ops.launch_host_us", TWO) == pytest.approx(14 / 2)
    assert _read("apps.wait_ms", TWO) == pytest.approx(10e-3)


def test_overlapping_children_count_once():
    """A child span that overlaps another (two threads' spans) is taken
    once: self time is the parent's union less its children's union."""
    ev = _query(0) + [_span("module.spmv", 20, 30)]   # over 12-40 and 45-50
    assert _read("apps.host_self_ms", ev) == pytest.approx(
        (100 - 28 - 10 - 25 - 5) * 1e-3)


def test_spans_outside_the_slice_are_ignored():
    """Spans before the first query's start or after the last wait's end
    lie outside the traced slice [t0, t1]."""
    outside = [_span("apps.sssp.pull_push", -500, 400),
               _span("module.spmv", -450, 300),
               _span("ops.roll.fused", -400, 100),
               _span("apps.host_read", -90, 50),
               _span("apps.sssp.pull_push", 900, 50),
               _span("ops.roll.fused", 910, 20)]
    for name in NAMES:
        assert _read(name, TWO + outside) == _read(name, TWO), name


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(name):
    """No trace, no queries, or no spans of the reader's kind: None, as
    on a program without the spans."""
    assert _reader(name).read(types.SimpleNamespace(trace=None)) is None
    assert _read(name, []) is None
    harness_only = [e for e in TWO if e["cat"] != "user_annotation"
                    or e["name"].startswith("bench.")]
    assert _read(name, harness_only) is None


def test_idle_gaps_name_the_programs_innermost_span():
    """Each idle gap is named by the program span innermost under its
    midpoint: a launch span, a step, the query's app span."""
    gaps = dict(Trace(_query(0)).idle_gaps())
    assert gaps == pytest.approx({"ops.chunked.chunked_pred": 40e-6,
                                  "apps.pull_step": 24e-6,
                                  "apps.sssp.pull_push": 24e-6})
