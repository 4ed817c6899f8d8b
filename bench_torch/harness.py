"""One run of one cell.

1. Draw the cell's graph (and, for SSSP, its query sources) from the seed.
2. Hand the app a host `CSRMatrix`, format it and send it to the card.
3. Warm up with queries of the cell's own shapes; that ends set-up.
4. For `seconds`, run queries in a closed loop with one client: each
   query is one call of the app's entry (the traffic's entry module), its
   answer left on the card, then a wait for the card. A sample of the
   answers, drawn from the seed, is kept.
5. Read the memory peak, free the program, and compare the sample with
   the plain float64 reference.

A traced run (`trace=True`) wraps the module entries in spans at start-up
and profiles a slice of the window; its metrics are the per-layer ones.
Without a card (`device` the CPU, which only the tests ask for) no time,
rate or device number is reported.
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch

import spec
import graph as graphs
from trace import QUERY_SPAN, SYNC_SPAN, Trace


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


class Sample:
    """The answers compared after the window: those of `k` completed
    queries whose places in the window's order are drawn from the seed
    before it opens, among the first `span`. Only those answers are
    copied, so a later query cannot overwrite them. Where the window
    completes fewer, the last answer stands in for those not reached."""

    def __init__(self, k: int, span: int, seed: int):
        rng = np.random.default_rng([seed, 0x5A3])
        self.picks = set(rng.choice(max(span, k), size=k,
                                    replace=False).tolist())
        self.items: list = []
        self.last = None

    def offer(self, i: int, query, out) -> None:
        if i in self.picks:
            self.items.append((query, out.clone()))
        else:
            self.last = (query, out)

    def answers(self) -> list:
        if len(self.items) < len(self.picks) and self.last is not None:
            return self.items + [self.last]
        return self.items


@contextlib.contextmanager
def module_spans(entry, on: bool):
    """Wrap the entry module's `SPANS` in `record_function` spans."""
    saved = []
    if on:
        for cls, meth, name in entry.SPANS:
            orig = cls.__dict__[meth]

            def wrapped(self, *a, _orig=orig, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _orig(self, *a, **k)

            saved.append((cls, meth, orig))
            setattr(cls, meth, wrapped)
    try:
        yield
    finally:
        for cls, meth, orig in saved:
            setattr(cls, meth, orig)


def launches(entry, app) -> int:
    """The engines' own launch counters, summed."""
    return sum(sum(e.launches.values()) for e in entry.engines(app)
               if e is not None and hasattr(e, "launches"))


def new_profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def reduce_profile(prof) -> Trace:
    """The profiled slice as a `Trace`; the exported file is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path)
    finally:
        os.unlink(path)


def window(entry, app, cell, queries, seconds, trace, cuda, seed) -> dict:
    """The measured window: a closed loop of queries for `seconds`."""
    config, traffic = cell.config, cell.traffic
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    span = (torch.profiler.record_function if trace
            else (lambda _name: contextlib.nullcontext()))
    prof = new_profiler() if trace and cuda else None
    trace_from, trace_queries = seconds / 4, int(traffic["trace_queries"])
    state = "before"                      # the profiled slice's state
    traced = 0
    sample = Sample(int(traffic["sample"]),
                    int(seconds * float(traffic["sample_floor_per_s"])), seed)
    lat_ms: list = []
    done: list = []                       # host time of each answer
    attempted = failed = 0
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    calls0 = launches(entry, app)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if prof is not None and state == "before" and now - t0 >= trace_from:
            prof.start()
            state = "on"
        q = queries[attempted % len(queries)]
        attempted += 1
        try:
            if cuda:
                e0.record()
            with span(QUERY_SPAN):
                out = entry.run(app, config, traffic, q)
            if cuda:
                e1.record()
            with span(SYNC_SPAN):
                sync()
        except Exception:            # a query that raised is a failure
            failed += 1
            if failed == 1:
                log("query failed:\n" + traceback.format_exc())
            continue
        if cuda:
            lat_ms.append(e0.elapsed_time(e1))
        done.append(time.perf_counter())
        sample.offer(attempted - 1 - failed, q, out)
        del out
        if state == "on":
            traced += 1
            if traced >= trace_queries:
                prof.stop()
                state = "done"
    t1 = time.perf_counter()
    if state == "on":
        prof.stop()
        state = "done"
    per_s = np.bincount((np.array(done) - t0).astype(np.int64),
                        minlength=int(seconds)) if done else []
    log(f"answers in each second of the window: {list(map(int, per_s))}")
    return dict(attempted=attempted, failed=failed, seconds=t1 - t0,
                lat_ms=lat_ms, sample=sample, calls=launches(entry, app) - calls0,
                prof=prof if state == "done" else None)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             scale: float | None = None) -> tuple:
    """(result dict, check lines) of one run; `t_start` is the process's
    start on the host clock, `scale` shrinks the graph (tests only)."""
    from graphlily_tpu_torch.config import EngineConfig
    from graphlily_tpu_torch.io.matrix import CSRMatrix

    cuda = device.type == "cuda"
    entry, traffic, config = cell.entry, cell.traffic, cell.config
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    if cuda:
        # the program builds its kernels at first use; loading them here
        # puts that on a line of its own (a checkout's first run builds)
        from graphlily_tpu_torch.ops import _build
        t = time.perf_counter()
        paths = _build.library_paths()
        todo = sum(not p.exists() for p in paths)
        _build.library()
        log(f"kernel library: {todo} of {len(paths)} sources built, "
            f"loaded in {time.perf_counter() - t:.3f} s (within set-up)")

    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    graph = graphs.make(config, gen, device, scale)
    queries = entry.queries(graph, config, traffic, gen)
    n = graph.num_vertices
    log(f"graph: {n} vertices, {graph.nnz} entries, drawn on {device.type} "
        f"in {time.perf_counter() - t:.3f} s; {len(queries)} distinct "
        f"queries")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    with module_spans(entry, trace):
        app = entry.make_app(EngineConfig(
            **config["engine"], device=None if cuda else "cpu"))
        csr = CSRMatrix(n, n, graph.weights.copy(), graph.indices.copy(),
                        graph.indptr.copy())
        t = time.perf_counter()
        entry.load(app, csr, config, traffic)
        sync()
        format_s = time.perf_counter() - t
        del csr
        init_s = {type(e).__name__: getattr(e, "init_seconds", None)
                  for e in entry.engines(app) if e is not None}
        log(f"format: {format_s:.3f} s (load_and_format_matrix + "
            f"send_matrix_host_to_device); engines' init_seconds {init_s}")
        for i in range(int(traffic["warmup_queries"])):
            entry.run(app, config, traffic, queries[i % len(queries)])
        sync()
        if trace and cuda:            # the profiler's own first start
            prof = new_profiler()
            prof.start()
            entry.run(app, config, traffic, queries[0])
            sync()
            prof.stop()
            del prof
        setup_s = time.perf_counter() - t_start
        log(f"set-up: {setup_s:.3f} s")

        warm = int(traffic["warmup_queries"]) % len(queries)
        w = window(entry, app, cell, queries[warm:] + queries[:warm], seconds,
                   trace, cuda, seed)
        completed = w["attempted"] - w["failed"]
        log(f"window: {w['attempted']} queries started, {w['failed']} "
            f"failed, {w['seconds']:.3f} s")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        kept = w["sample"].answers()
        checked = [q for q, _ in kept]
        got = [entry.answer(app, out, n) for _, out in kept]
        tr = reduce_profile(w["prof"]) if w["prof"] is not None else None
        del app, w["sample"], kept
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    t = time.perf_counter()
    want = cell.reference.solve(graph, config, traffic, checked, "float64",
                                device)
    checks = cell.reference.compare(got, want, traffic)
    log(f"reference: {len(checked)} answers compared in "
        f"{time.perf_counter() - t:.3f} s")
    limits = cell.workload["limits"]
    correct = (completed > 0 and w["failed"] == 0 and len(got) > 0
               and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in checks))

    metrics = {}
    if cuda and not trace:
        values = {
            "queries_per_s": completed / w["seconds"],
            "query_p95_ms": (float(np.percentile(w["lat_ms"], 95))
                             if w["lat_ms"] else None),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    if trace:
        ctx = types.SimpleNamespace(
            cuda=cuda, trace=tr, queries=completed, calls=w["calls"],
            format_s=format_s, graph=graph,
            peaks=(spec.load_json(spec.BENCH_DIR / "peaks.json").get(
                torch.cuda.get_device_name(0)) if cuda else None))
        for m, reader in cell.metric_readers():
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if tr is not None:
        log(f"trace: {tr.queries} queries, {len(tr.gpu)} device operations, "
            f"{100 * tr.attributed():.2f}% placed by their launch call, "
            f"{len(tr.launch)} runtime calls, spans "
            f"{ {k: len(v) for k, v in tr.spans.items()} }")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": peak}
    if tr is not None:
        device_info["busy_s"] = tr.busy_us() * 1e-6
        device_info["window_s"] = tr.window_us * 1e-6
    result = {"correct": bool(correct), "attempted": w["attempted"],
              "failed": w["failed"], "metrics": metrics,
              "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in checks.items()}
    lines = [f"check {k}: {v} (limit {limits.get(k)})"
             for k, v in checks.items()]
    lines.append(f"correct: {bool(correct)} ({completed} of "
                 f"{w['attempted']} queries completed, {len(got)} compared)")
    return result, lines
