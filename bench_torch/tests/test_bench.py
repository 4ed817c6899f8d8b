"""CPU rehearsal of the benchmark: its files, a run at a tiny size, the
comparison against both references, the control and planted faults.

    python -m pytest bench_torch/tests -q

The runs here use `EngineConfig(device="cpu")` (the kernels' plain
versions) and a graph shrunk by `scale`; they report no time, rate or
device number. A run on the card is `bench_torch/run.py`.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

import control  # noqa: E402
from faults import FAULTS  # noqa: E402
import harness  # noqa: E402
import precision  # noqa: E402
import spec  # noqa: E402
import graph  # noqa: E402
from graph import out_degree_sources  # noqa: E402
from trace import Trace  # noqa: E402

BENCH = spec.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")
SCALE = 0.01
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(name: str, trace: bool = False, seed: int = SEED):
    cell = spec.load_cell(name)
    return harness.run_cell(cell, seed, 0.3, trace, CPU,
                            time.perf_counter(), scale=SCALE)


# ---- the files ---------------------------------------------------------

def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_torch"]
    assert BENCH["command"][1] == "bench_torch/run.py"
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["layer"] == m["name"].split(".")[0]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert entry["reduced"] == cell.config["reduced"]
    assert entry["source"] == cell.config["source"]
    assert set(cell.workload["limits"]) == set(
        cell.reference.compare([np.ones(3)], [np.ones(3)], cell.traffic))
    for m, reader in cell.metric_readers():
        assert callable(reader.read), m["name"]
    assert cell.per_layer and len(cell.end_to_end) >= 2


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert files == listed


def test_nothing_imports_jax_or_the_old_bench():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|graphlily_tpu)\b",
                     re.M)
    old = re.compile(r"BENCH_(r0|DETAILS)|\bbench\.py|BASELINE\.json")
    for p in BENCH_DIR.rglob("*.py"):
        text = p.read_text()
        assert not pat.search(text), p
        assert p.name == Path(__file__).name or not old.search(text), p


# ---- the generator -----------------------------------------------------

def _kronecker(scale: int, seed: int):
    g = torch.Generator(device=CPU)
    g.manual_seed(seed)
    config = {"graph": {"generator": "kronecker", "scale": scale,
                        "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}}
    return graph.make(config, g, CPU), g


def test_graph_from_seed():
    (a, ga), (b, gb), (c, _) = (_kronecker(11, SEED), _kronecker(11, SEED),
                                _kronecker(11, SEED + 1))
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.weights, b.weights)
    assert not np.array_equal(a.indices, c.indices)
    assert a.num_vertices == 2048 and a.nnz == c.nnz == 2 * 16 * 2048
    assert a.indptr.dtype == np.uint32
    assert np.all(np.diff(a.indptr.astype(np.int64)) >= 0)
    assert a.weights.min() >= 0 and a.weights.max() < 1
    # undirected: the entries, weights included, are symmetric
    rows, cols = a.rows(), a.indices.astype(np.int64)
    fwd = np.lexsort((a.weights, cols, rows))
    bwd = np.lexsort((a.weights, rows, cols))
    assert np.array_equal(rows[fwd], cols[bwd])
    assert np.array_equal(a.weights[fwd], a.weights[bwd])
    # the Kronecker skew survives the label permutation
    deg = np.diff(a.indptr.astype(np.int64))
    assert deg.max() > 20 * deg.mean() and np.count_nonzero(deg == 0) > 0
    src = out_degree_sources(a, 500, ga)
    other = np.bincount(cols[cols != rows], minlength=2048)
    assert np.all(other[src] >= 1)
    assert np.array_equal(src, out_degree_sources(b, 500, gb))


def test_graph_generator_found_by_name(tmp_path, monkeypatch):
    """A configuration's `graph.generator` names the module that draws
    its graph."""
    (tmp_path / "graphs").mkdir()
    (tmp_path / "graphs" / "ring.py").write_text(
        "import numpy as np\n"
        "from graph import Graph\n"
        "def make(config, gen, device, scale):\n"
        "    n = config['graph']['n']\n"
        "    return Graph(n, np.arange(n + 1, dtype=np.uint32),\n"
        "                 np.roll(np.arange(n, dtype=np.uint32), 1),\n"
        "                 np.ones(n, np.float32))\n")
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    g = graph.make({"graph": {"generator": "ring", "n": 5}},
                   torch.Generator(), CPU)
    assert g.nnz == 5 and list(g.indices) == [4, 0, 1, 2, 3]


# ---- a run at a tiny size on the CPU -----------------------------------

@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_line(name, trace, capsys):
    result, lines = run_tiny(name, trace)
    import run
    run.emit(result, lines)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True
    assert last["attempted"] > 0 and last["failed"] == 0
    assert last["device"]["platform"] == "cpu"
    assert "busy_s" not in last["device"] and "breakdown" not in last
    # no time, rate or device number from a CPU run
    timed = {m["name"] for m in BENCH["end_to_end"]} | {
        m["name"] for m in BENCH["per_layer"] if m["source"] != "program_counter"}
    assert not timed & set(last["metrics"])
    for k, v in last["checks"].items():
        assert v["value"] <= v["limit"]
        assert f"check {k}: " in out.err
    assert out.err.strip().splitlines()[-1].startswith("correct: True")


def test_cli_without_a_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("loaded", ["jax", "jaxlib.xla_client", "flax",
                                    "graphlily_tpu.apps", None])
def test_run_prints_no_result_with_jax_loaded(loaded, monkeypatch, capsys):
    """Once the window has closed, a process that holds JAX, jaxlib, flax
    or the JAX package (by whole top-level name) prints no result and
    exits with another code than 0; the port alone does not stop it."""
    import types

    import run
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    spec.load_cell(CELLS[0])              # its traffic imports the port
    assert "graphlily_tpu_torch" in sys.modules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card_line", lambda: "a stand-in card")
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: ({"correct": True}, ["correct: True"]))
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    if loaded:
        assert rc != 0 and out.out == ""
        assert loaded.split(".")[0] in out.err.strip().splitlines()[-1]
    else:
        assert rc == 0 and json.loads(out.out) == {"correct": True}


def test_cli_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


# ---- the references ----------------------------------------------------

def _graph(seed):
    return _kronecker(12, seed)


def _csr(graph):
    from graphlily_tpu_torch.io.matrix import CSRMatrix
    n = graph.num_vertices
    return CSRMatrix(n, n, graph.weights.copy(), graph.indices.copy(),
                     graph.indptr.copy())


@pytest.mark.parametrize("seed", [1, SEED])
def test_pagerank_reference_matches_the_apps_oracle(seed):
    from graphlily_tpu_torch.apps import PageRank
    from graphlily_tpu_torch.config import EngineConfig
    cell = spec.load_cell("graph500-s18.pagerank")
    graph, _ = _graph(seed)
    app = PageRank(EngineConfig(device="cpu", sort_rows_by_degree=True))
    app.load_and_format_matrix(_csr(graph), damping=0.9)
    oracle = app.compute_reference_results(0.9, 10)[:graph.num_vertices]
    mine = cell.reference.solve(graph, cell.config, cell.traffic, [None],
                                "float64", CPU)[0]
    # the oracle takes the app's float32 matrix values (d / out-degree,
    # rounded twice); the reference takes them exact
    np.testing.assert_allclose(mine, oracle, rtol=4 * 2.0**-24, atol=0)


@pytest.mark.parametrize("seed", [1, SEED])
def test_sssp_reference_matches_the_apps_oracle(seed):
    from graphlily_tpu_torch.apps import SSSP
    from graphlily_tpu_torch.config import EngineConfig
    cell = spec.load_cell("graph500-s18.sssp")
    graph, gen = _graph(seed)
    sources = out_degree_sources(graph, 3, gen)
    app = SSSP(EngineConfig(device="cpu", sort_rows_by_degree=True))
    app.load_and_format_matrix(_csr(graph), unit_weights=False)
    mine = cell.reference.solve(graph, cell.config, cell.traffic, sources,
                                "float64", CPU)
    for s, d in zip(sources, mine):
        oracle = app.compute_reference_results(
            int(s), cell.config["iterations"]["sssp"])[:graph.num_vertices]
        reached = oracle < cell.traffic["infinity"]
        assert np.array_equal(np.isfinite(d), reached)
        np.testing.assert_allclose(d[reached], oracle[reached], rtol=1e-12,
                                   atol=0)


# ---- the control and the faults ----------------------------------------

REFERENCES = sorted(p.stem for p in (BENCH_DIR / "reference").glob("*.py"))
# each traffic of a cell, with the first cell that runs it
TRAFFICS = {}
for _w in BENCH["workloads"]:
    TRAFFICS.setdefault(_w["traffic"], _w["name"])


@pytest.mark.parametrize("ref", REFERENCES)
def test_reference_declares_its_modes(ref):
    """Each reference names at least one control mode and one sound
    mode, none of them both."""
    mod = spec.load_module(BENCH_DIR / "reference" / f"{ref}.py")
    for modes in (mod.CONTROLS, mod.SOUND):
        assert isinstance(modes, tuple) and modes
        assert all(isinstance(m, str) for m in modes)
    assert not set(mod.CONTROLS) & set(mod.SOUND)


@pytest.mark.parametrize("traffic", list(TRAFFICS))
def test_traffic_entry_is_what_run_calls(traffic, monkeypatch):
    """Each traffic's `ENTRY` is the app entry that its `run` calls, once
    a query, and it has an `alter`."""
    cell = spec.load_cell(TRAFFICS[traffic])
    assert callable(cell.entry.alter)
    cls, meth = cell.entry.ENTRY
    orig = getattr(cls, meth)
    calls = []

    def counted(self, *a, **k):
        calls.append(meth)
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, meth, counted)
    result, _ = run_tiny(TRAFFICS[traffic])
    assert result["correct"] is True and result["failed"] == 0
    assert len(calls) == (int(cell.traffic["warmup_queries"])
                          + result["attempted"])


# the step below each precision a configuration states (`precision.py`)
BELOW = {"float64": "float32", "float32": "tf32"}


@pytest.mark.parametrize("name", CELLS)
def test_float_cell_controls_the_precision_below(name):
    """A cell with a limit above 0 compares floats: its reference's
    `CONTROLS` hold the precision below the one its configuration states.
    Only an exact cell (every limit 0) names a control of its own."""
    cell = spec.load_cell(name)
    if any(v > 0 for v in cell.workload["limits"].values()):
        below = BELOW[cell.config["engine"]["dtype"]]
        assert below in precision.MODES
        assert below in cell.reference.CONTROLS


@pytest.mark.parametrize("seed", [3, 5, SEED])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, seed):
    """The reference in each of its `CONTROLS` modes (for the float
    references, TF32), put in the program's place, fails the cell's
    limits; in each of its `SOUND` modes (float32) it is within them."""
    cell = spec.load_cell(name)
    ref = cell.reference
    recs = control.control(cell, seed, ref.CONTROLS + ref.SOUND, CPU,
                           scale=SCALE)
    assert [r["role"] for r in recs] == (["control"] * len(ref.CONTROLS)
                                         + ["sound"] * len(ref.SOUND))
    for rec in recs:
        if rec["role"] == "control":
            assert not all(rec["within"].values()), rec
        else:
            assert all(rec["within"].values()), rec


def test_control_role_of_an_undeclared_mode():
    """A mode that the reference declares in neither `CONTROLS` nor
    `SOUND` (float64, the reference itself) is given no role."""
    cell = spec.load_cell(CELLS[0])
    assert "float64" not in cell.reference.CONTROLS + cell.reference.SOUND
    (rec,) = control.control(cell, SEED, ["float64"], CPU, scale=SCALE)
    assert rec["role"] is None and all(rec["within"].values())


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    """The run with the timed path broken underneath reads not correct."""
    FAULTS[fault](monkeypatch, spec.load_cell(name))
    result, _ = run_tiny(name)
    assert result["correct"] is False, result["checks"]


# ---- the trace reduction -----------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    ev = [
        _ev("user_annotation", "bench.query", 0, 40),
        _ev("user_annotation", "SpMVModule.apply", 5, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2),
        _ev("cuda_runtime", "cudaStreamSynchronize", 30, 5),
        _ev("user_annotation", "bench.sync", 41, 20),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 42, 18),
        _ev("kernel", "k1", 10, 20, corr=1),
        _ev("kernel", "k2", 35, 10, corr=2),
        _ev("kernel", "outside", 500, 10, corr=9),
    ]
    t = Trace(ev)
    assert t.queries == 1 and t.window_us == 61
    assert t.under("SpMVModule.apply") == (20.0, 1)
    assert t.syncs() == 1
    assert t.busy_us() == 30.0
    assert len(t.kernels()) == 2 and t.attributed() == 1.0
    assert t.top_ops()[0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(t.idle_gaps())
    assert abs(sum(gaps.values()) - 31e-6) < 1e-12
    # each gap is named by the innermost host event under its midpoint
    assert gaps == pytest.approx({"SpMVModule.apply": 10e-6,
                                  "cudaStreamSynchronize": 5e-6,
                                  "cudaDeviceSynchronize": 16e-6})
