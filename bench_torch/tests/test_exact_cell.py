"""A cell whose answer is exact, taken by the benchmark from new files
alone.

The fixture writes a toy BFS cell into a directory of its own: a
configuration (a Kronecker graph of 1,024 vertices), a traffic mix and
its entry module (hop levels from the port's `BFS.pull_push` on the
CPU), a reference with an exact comparison and its own control mode, and
the cell's limits; the Kronecker generator and one metric reader are
copied beside them. `spec` is pointed at that directory, and nothing of
the benchmark's own files changes: the cell is found by its names, runs
correct, its control fails and its sound mode passes, and each planted
fault reads not correct.

    python -m pytest bench_torch/tests/test_exact_cell.py -q
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]

import control  # noqa: E402
from faults import FAULTS  # noqa: E402
import harness  # noqa: E402
import spec  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 977
CELL = "kronecker-toy.bfs"

CONFIG = {
    "name": "kronecker-toy",
    "source": "Graph 500 benchmark specification v3.0 (graph500.org), "
              "section 3 and kernel 2 (BFS)",
    "graph": {"generator": "kronecker", "scale": 10, "edgefactor": 16,
              "a": 0.57, "b": 0.19, "c": 0.19},
    "iterations": {"bfs": 8},
    "engine": {"dtype": "float32", "engine": "auto",
               "sort_rows_by_degree": True},
    "reduced": ["scale"],
}

TRAFFIC = {
    "entry": "bfs_toy",
    "reference": "bfs_levels",
    "threshold": 0.05,
    "sources": 64,
    "warmup_queries": 2,
    "sample": 4,
    "sample_floor_per_s": 20,
    "trace_queries": 4,
}

ENTRY = '''"""BFS's query: one call of `BFS.pull_push(source, iterations,
threshold, device_output=True)` from a fresh source each time."""
from graphlily_tpu_torch.apps import BFS
from graphlily_tpu_torch.module import SpMSpVModule, SpMVModule

from graph import out_degree_sources

SPANS = [(SpMVModule, "apply", "SpMVModule.apply"),
         (SpMSpVModule, "apply_dense", "SpMSpVModule.apply_dense")]
ENTRY = (BFS, "pull_push")


def make_app(engine_config):
    return BFS(engine_config)


def load(app, csr, config, traffic):
    app.load_and_format_matrix(csr)
    app.send_matrix_host_to_device()


def queries(graph, config, traffic, gen):
    return [int(s) for s in out_degree_sources(graph, traffic["sources"],
                                                gen)]


def run(app, config, traffic, source):
    return app.pull_push(source, config["iterations"]["bfs"],
                         traffic["threshold"], device_output=True)


def engines(app):
    seen = {}
    for eng in (app.SpMV_.engine, app.SpMSpV_.engine):
        seen.setdefault(id(eng), eng)
    return list(seen.values())


def answer(app, out, num_vertices):
    return app._external(out.cpu().numpy())[:num_vertices]


def alter(out):
    """One vertex's level off by one."""
    out = out.clone()
    out[out.argmax()] += 1
    return out
'''

REFERENCE = '''"""BFS levels within `iterations` hops, plain: 1 at the
source, h + 1 at each vertex first reached at hop h, 0 where none is
reached."""
import numpy as np
import torch

CONTROLS = ("short",)
SOUND = ("float32",)


def levels(rows, cols, n, source, hops, dt):
    d = torch.zeros(n, dtype=dt, device=rows.device)
    d[source] = 1
    frontier = d != 0
    for hop in range(1, hops + 1):
        hit = torch.zeros(n, dtype=torch.bool, device=rows.device)
        hit[rows[frontier[cols]]] = True
        frontier = hit & (d == 0)
        d[frontier] = hop + 1
    return d


def solve(graph, config, traffic, queries, mode, device):
    """"short" stops one hop short of the deepest level that the full
    search reaches: the least early exit that changes the answer."""
    if mode not in ("float64", "float32", "short"):
        raise ValueError(f"unknown mode {mode!r}")
    dt = torch.float32 if mode == "float32" else torch.float64
    n = graph.num_vertices
    rows = torch.from_numpy(graph.rows()).to(device)
    cols = torch.from_numpy(graph.indices.astype(np.int64)).to(device)
    hops = int(config["iterations"]["bfs"])
    out = []
    for source in queries:
        d = levels(rows, cols, n, int(source), hops, dt)
        if mode == "short":
            d = levels(rows, cols, n, int(source), int(d.max()) - 2, dt)
        out.append(d.cpu().numpy().astype(np.float64))
    return out


def compare(got, want, traffic):
    """level_mismatch: vertices whose level differs, over every answer."""
    mismatch = 0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g, np.float64)
        if g.shape != w.shape:
            return {"level_mismatch": float(len(w))}
        mismatch += int(np.count_nonzero(g != w))
    return {"level_mismatch": float(mismatch)}
'''

BENCH = {
    "configs": [{"name": CONFIG["name"], "source": CONFIG["source"],
                 "file": "configs/kronecker-toy.json",
                 "reduced": CONFIG["reduced"], "why": "toy"}],
    "workloads": [{"name": CELL, "config": CONFIG["name"],
                   "traffic": "bfs_toy", "chips": 1, "why": "toy"}],
    "end_to_end": [{"name": "queries_per_s", "unit": "queries/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": "ops.kernel_calls_per_query", "unit": "count",
                   "better": "lower", "source": "program_counter",
                   "layer": "ops", "moves": "queries_per_s",
                   "workloads": [CELL]}],
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cell(tmp_path, monkeypatch):
    """The toy cell's files under `tmp_path`, found there by name."""
    files = {
        "configs/kronecker-toy.json": json.dumps(CONFIG),
        "traffic/bfs_toy.json": json.dumps(TRAFFIC),
        "traffic/bfs_toy.py": ENTRY,
        "reference/bfs_levels.py": REFERENCE,
        f"workloads/{CELL}.json": json.dumps(
            {"limits": {"level_mismatch": 0}}),
    }
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    for name in ("graphs/kronecker.py",
                 "metrics/ops.kernel_calls_per_query.py"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(BENCH_DIR / name, tmp_path / name)
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return spec.load_cell(CELL, BENCH)


def run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, CPU, time.perf_counter())


def test_found_by_file(cell, tmp_path):
    from graphlily_tpu_torch.apps import BFS
    assert cell.config == CONFIG and cell.traffic == TRAFFIC
    assert cell.workload["limits"] == {"level_mismatch": 0}
    assert Path(cell.entry.__file__).parent == tmp_path / "traffic"
    assert Path(cell.reference.__file__).parent == tmp_path / "reference"
    assert cell.entry.ENTRY == (BFS, "pull_push")
    assert (cell.reference.CONTROLS, cell.reference.SOUND) == (
        ("short",), ("float32",))
    assert set(cell.workload["limits"]) == set(
        cell.reference.compare([np.ones(3)], [np.ones(3)], cell.traffic))
    (m, reader), = cell.metric_readers()
    assert m["name"] == "ops.kernel_calls_per_query" and callable(reader.read)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_tiny_run_is_correct(cell, trace):
    result, lines = run(cell, trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"] == {"level_mismatch": {"value": 0.0, "limit": 0}}
    assert lines[-1].startswith("correct: True")
    if trace:
        assert "ops.kernel_calls_per_query" in result["metrics"]


@pytest.mark.parametrize("seed", [3, 5, SEED])
def test_control_fails_and_sound_passes(cell, seed):
    """Stopped one hop short of its deepest level, the reference fails
    the exact limit; in float32 it is within it. The deepest level lies
    under the hop limit, so a fixed hop fewer would change nothing."""
    short, f32 = control.control(cell, seed, ("short", "float32"), CPU)
    assert (short["role"], f32["role"]) == ("control", "sound")
    assert short["checks"]["level_mismatch"] > 0
    assert not all(short["within"].values())
    assert all(f32["within"].values())
    want = cell.reference.solve(*_sampled(cell, seed), "float64", CPU)
    assert max(d.max() for d in want) - 1 < CONFIG["iterations"]["bfs"]


def _sampled(cell, seed):
    """The graph and sample `control.control` draws for `seed`."""
    import graph as graphs
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    g = graphs.make(cell.config, gen, CPU)
    queries = cell.entry.queries(g, cell.config, cell.traffic, gen)
    k = int(cell.traffic["sample"])
    return g, cell.config, cell.traffic, (queries * k)[:k]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    result, _ = run(cell)
    assert result["correct"] is False, result["checks"]
