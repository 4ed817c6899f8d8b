"""Finds a cell's pieces by name.

`BENCHMARK.json` at the root names each cell's configuration and traffic
mix and lists the metrics. Everything that belongs to one of them is a
file of its own under `bench_torch/`, found by its name:

- `configs/<config>.json`: the graph and the engine settings;
- `traffic/<traffic>.json`: the traffic mix's parameters, whose `entry`
  names `traffic/<entry>.py`, the module that calls the app's entry for
  one query, and whose `reference` names `reference/<reference>.py`;
- `workloads/<cell>.json`: the cell's limits on the numbers compared;
- `metrics/<metric>.py`: one per-layer metric's reader.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file; the names of metric files hold dots."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list
    entry: object
    reference: object

    def metric_readers(self) -> list:
        """(metric entry, reader module) of each per-layer metric that
        this cell reports."""
        return [(m, load_module(BENCH_DIR / "metrics" / f"{m['name']}.py"))
                for m in self.per_layer]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(ROOT / config_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")

    def here(m: dict) -> bool:
        return name in m.get("workloads", [name])

    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        workload=load_json(BENCH_DIR / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if here(m)],
        per_layer=[m for m in bench["per_layer"] if here(m)],
        entry=load_module(BENCH_DIR / "traffic" / f"{traffic['entry']}.py"),
        reference=load_module(
            BENCH_DIR / "reference" / f"{traffic['reference']}.py"))
