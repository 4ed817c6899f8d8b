#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphlily_tpu_torch) on one GPU.

Drives the port's main path once at the full googleplus stand-in (RMAT,
107,614 vertices, 13,673,453 edges, seed 0, degree-sorted), through the
entry points a user calls, and checks every result against the float64
oracles. Phases, one or more lines each:

  1. card      nvidia-smi name and power limit; TF32 switched off
  2. build     nvcc build of csrc/*.cu (seconds)
  3. kernels   K1 fused, K2 scatter, K3 reduce and their plain PyTorch
               versions on the router layout, MULADD and ANDOR, each held
               against SpMVModule.compute_reference_results; K2's flush
               stream must equal its plain version bit for bit
  4. pagerank  PageRank.pull(0.9, 10): engine roll, fused branch
  5. bfs       BFS.pull(0, 7), once on the fused branch and once on the
               split branch (K2 -> K3), each equal to the oracle
  6. times     CUDA events, min over 5 reps of a 100-call loop: SpMV ms and
               GTEPS (nnz / time per SpMV) for the kernels and the plain
               versions, PageRank ms/iter, BFS pull ms

The launch counters are set to 0 right before phases 4-5 (the main path)
and read right after; every kernel must have run there. Then it prints
the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Any failure raises: the exit code is not 0 and the ok line is not printed.

Usage: python3 chip_smoke.py [--scale S]   (S < 1 shrinks the graph)
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SOURCE = "graphlily_tpu_torch/csrc/router_spmv.cu"
REPLACES = {
    "K1_router_fused": "graphlily_tpu/ops/router_pallas.py:419",
    "K2_router_scatter": "graphlily_tpu/ops/router_pallas.py:368",
    "K3_router_reduce": "graphlily_tpu/ops/router_pallas.py:756",
}
MULADD_RTOL = 1e-4   # fp32 atomics in any order over hub rows of ~1e5 terms


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 100, reps: int = 5) -> float:
    """Min over `reps` of the mean time of `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def check_close(label: str, y, want: np.ndarray, exact: bool) -> float:
    y = np.asarray(y, np.float64)[:len(want)]
    if not np.all(np.isfinite(y)) or y.shape != want.shape:
        raise AssertionError(f"{label}: non-finite values or wrong shape")
    err = float(np.abs(y - want).max())
    bound = 0.0 if exact else MULADD_RTOL * float(np.abs(want).max())
    if err > bound:
        raise AssertionError(f"{label}: max|y - y64| = {err} > {bound}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="graph scale (1.0 = the full googleplus stand-in)")
    args = ap.parse_args(argv)
    if not (ROOT / "graphlily_tpu_torch").is_dir():
        print("chip_smoke: graphlily_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from graphlily_tpu_torch import (EngineConfig, ArithmeticSemiring,
                                     LogicalSemiring)
    from graphlily_tpu_torch.apps import PageRank, BFS
    from graphlily_tpu_torch.io import (iccad_standin, ICCAD_GRAPHS,
                                        degree_sort_permutation,
                                        symmetric_permute,
                                        util_round_csr_matrix_dim)
    from graphlily_tpu_torch.module import SpMVModule
    from graphlily_tpu_torch.ops import _build

    # ---- 1. card --------------------------------------------------------
    card = card_line()
    log("phase 1 card (nvidia-smi name, power.limit):")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1 tf32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name})")

    # ---- 3. kernels vs plain versions, against the float64 oracle ---------
    t0 = time.perf_counter()
    g = iccad_standin("googleplus", scale=args.scale, seed=0)
    perm = degree_sort_permutation(g)
    gs = symmetric_permute(g, perm)
    util_round_csr_matrix_dim(gs, 1024, 1024)
    log(f"phase 3 graph: googleplus stand-in scale={args.scale} "
        f"rows={g.num_rows} padded={gs.num_rows} nnz={gs.nnz} "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = EngineConfig(engine="router", device="cuda")
    rng = np.random.default_rng(0)
    errs, engines, xs = {}, {}, {}
    for semiring in (ArithmeticSemiring, LogicalSemiring):
        t0 = time.perf_counter()
        mod = SpMVModule(cfg)
        mod.set_semiring(semiring)
        mod.load_and_format_matrix(gs)
        eng = mod.engine
        assert mod.engine_name == "roll", mod.engine_name
        log(f"phase 3 {semiring.name} layout: pack+init "
            f"{time.perf_counter() - t0:.1f} s region_rows={eng.region_rows} "
            f"regions={eng.num_regions} cb={eng.cb} rstep={eng.rstep} "
            f"dstep={eng.dstep} f={eng.f} nsteps={eng.nsteps} "
            f"stream_MB={eng.nsteps * eng.f * 4096 / 1e6:.1f} "
            f"y_MB={eng.out_len * 4 / 1e6:.2f} fused={eng.fused}")
        exact = semiring is LogicalSemiring
        if exact:
            x = (rng.random(eng.num_cols) < 0.05).astype(np.float32)
        else:
            x = rng.random(eng.num_cols).astype(np.float32)
        xt = torch.from_numpy(x).to(dev)
        want = mod.compute_reference_results(x)
        y1 = eng.fused_spmv(xt)
        y1p = eng.fused_plain(xt)
        s2 = eng.scatter(xt)
        s2p = eng.scatter_plain(xt)
        y3 = eng.reduce(s2)
        y3p = eng.reduce_plain(s2)
        torch.cuda.synchronize()
        if not torch.equal(s2.view(torch.int32), s2p.view(torch.int32)):
            raise AssertionError(f"{semiring.name}: K2 stream differs from "
                                 "its plain version")
        for label, y in (("K1", y1), ("K1 plain", y1p), ("K3 (K2->K3)", y3),
                         ("K3 plain", y3p), ("engine call", mod.apply(xt))):
            y = y.cpu().numpy()
            if exact:
                y = (y != 0).astype(np.float64)
            err = check_close(f"{semiring.name} {label}", y, want, exact)
            log(f"phase 3 {semiring.name} {label}: max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        if not exact:
            errs = {
                "K1_router_fused": float((y1 - y1p).abs().max()),
                "K2_router_scatter": float((s2 - s2p).abs().max()),
                "K3_router_reduce": float((y3 - y3p).abs().max()),
            }
            engines["spmv"], xs["spmv"] = eng, xt
        log(f"phase 3 {semiring.name}: K2 stream bit-equal to plain; ok")

    # ---- 4-5. main path: PageRank and BFS through the public API ----------
    # the auto ladder picks the roll router at full size (nnz >= 2M); a
    # shrunken graph asks for it by name
    app_cfg = EngineConfig(sort_rows_by_degree=True,
                           engine="auto" if args.scale >= 1 else "router")
    t0 = time.perf_counter()
    pr = PageRank(app_cfg)
    pr.load_and_format_matrix(g, 0.9)
    bfs = BFS(app_cfg)
    bfs.load_and_format_matrix(g)
    log(f"phase 4-5 load_and_format_matrix: {time.perf_counter() - t0:.1f} s")
    for app in (pr, bfs):
        if app.SpMV_.engine_name != "roll" or not app.SpMV_.engine.fused:
            raise AssertionError(f"{type(app).__name__} resolved "
                                 f"{app.SpMV_.engine_name!r}, not fused roll")
    pr_eng, bfs_eng = pr.SpMV_.engine, bfs.SpMV_.engine
    iters = ICCAD_GRAPHS["googleplus"]["iters"]
    for eng in (pr_eng, bfs_eng):
        eng.launches = dict.fromkeys(eng.launches, 0)
    rank = pr.pull(0.9, 10)
    dist_fused = bfs.pull(0, iters)
    bfs_eng.fused = False          # the split branch, through the same API
    dist_split = bfs.pull(0, iters)
    bfs_eng.fused = True
    torch.cuda.synchronize()
    launches = {
        "K1_router_fused": pr_eng.launches["fused"] + bfs_eng.launches["fused"],
        "K2_router_scatter": bfs_eng.launches["scatter"],
        "K3_router_reduce": bfs_eng.launches["reduce"],
    }
    log(f"phase 4-5 launches: pagerank {pr_eng.launches} bfs "
        f"{bfs_eng.launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    err = check_close("pagerank", rank, pr.compute_reference_results(0.9, 10),
                      exact=False)
    log(f"phase 4 pagerank pull(0.9, 10): engine=roll fused "
        f"max|r-r64|={err:.3e} ok")
    want = bfs.compute_reference_results(0, iters)
    check_close("bfs fused", dist_fused, want, exact=True)
    check_close("bfs split", dist_split, want, exact=True)
    log(f"phase 5 bfs pull(0, {iters}): fused and split equal the oracle "
        f"({int((want > 0).sum())} reached) ok")

    # ---- 6. times ---------------------------------------------------------
    eng, xt = engines["spmv"], xs["spmv"]
    nnz = eng.nnz
    stream = eng.scatter(xt)
    ms = {
        "K1_router_fused": time_ms(torch, lambda: eng.fused_spmv(xt)),
        "K2_router_scatter": time_ms(torch, lambda: eng.scatter(xt)),
        "K3_router_reduce": time_ms(torch, lambda: eng.reduce(stream)),
    }
    plain_ms = {
        "K1_router_fused": time_ms(torch, lambda: eng.fused_plain(xt)),
        "K2_router_scatter": time_ms(torch, lambda: eng.scatter_plain(xt)),
        "K3_router_reduce": time_ms(torch, lambda: eng.reduce_plain(stream)),
    }
    spmv_ms = time_ms(torch, lambda: eng(xt))
    split_ms = time_ms(torch, lambda: eng.reduce(eng.scatter(xt)))
    pr_ms = time_ms(torch, lambda: pr.pull(0.9, 100, device_output=True),
                    iters=1, reps=3) / 100
    bfs_ms = time_ms(torch, lambda: bfs.pull(0, iters, device_output=True),
                     iters=5, reps=3)
    for name in ms:
        log(f"phase 6 {name}: {ms[name]:.4f} ms ({nnz / ms[name] / 1e6:.2f} "
            f"GTEPS) plain {plain_ms[name]:.4f} ms "
            f"({nnz / plain_ms[name] / 1e6:.2f} GTEPS)")
    log(f"phase 6 spmv engine call (fused): {spmv_ms:.4f} ms "
        f"({nnz / spmv_ms / 1e6:.2f} GTEPS); split K2->K3 {split_ms:.4f} ms "
        f"({nnz / split_ms / 1e6:.2f} GTEPS)")
    log(f"phase 6 pagerank: {pr_ms:.4f} ms/iter; bfs pull({iters}): "
        f"{bfs_ms:.4f} ms; card {card}")

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain_ms[name],
    } for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
