#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphlily_tpu_torch) on one GPU.

Drives the port's main paths once, through the entry points a user
calls, and checks every result against the float64 oracles:

  * the googleplus stand-in (RMAT, 107,614 vertices, 13,673,453 edges,
    seed 0, degree-sorted) through the roll router (K1, K2, K3);
  * the pokec stand-in (RMAT, 1,632,803 vertices, 30,622,564 edges,
    seed 0, degree-sorted) through the planar router (K4 fused, K4
    scatter -> K3, and K5 under planar_deal="bucket");
  * SSSP on the googleplus stand-in (self edges added: 13,780,368 nnz),
    through the chunked engine (the K6/K7 kernel), and PageRank and BFS
    on the googleplus stand-in at scale 0.1, which the ladder also sends
    to the chunked engine.

Phases, one or more lines each:

  1. card      nvidia-smi name and power limit; TF32 switched off
  2. build     nvcc build of csrc/*.cu, one nvcc per source, in parallel
  3. kernels   googleplus: K1, K2, K3 and their plain PyTorch versions on
               the router layout, MULADD and ANDOR, each held against
               SpMVModule.compute_reference_results; K2's flush stream
               must equal its plain version bit for bit
  4. pagerank  googleplus PageRank.pull(0.9, 10): engine roll, fused
  5. bfs       googleplus BFS.pull(0, 7), fused and split (K2 -> K3)
  6. times     googleplus, CUDA events, min over 5 reps of a 100-call
               loop: kernels and plain versions (ms, GTEPS), PageRank
               ms/iter, BFS pull ms
  7. pokec     the graph, then PageRank and BFS formatted through
               EngineConfig(sort_rows_by_degree=True) (engine "auto" ->
               planar, deal "free"), layout facts and pack seconds; a
               third BFS packs the "bucket" deal
  8. apps      pokec PageRank.pull(0.9, 10) and BFS.pull(0, 11) fused and
               split, and BFS.pull(0, 11) on the bucket layout (K5)
  9. kernels   pokec, on the apps' engines: K4 fused and K4 scatter -> K3
               against their plain versions and the oracle, MULADD
               (PageRank's engine) and ANDOR (BFS's); K4's flush stream
               and K5's x2 bit-equal to their plain versions
  10. times    pokec, as phase 6, plus the planar engine call fused and
               split
  11. sssp     googleplus SSSP(EngineConfig(sort_rows_by_degree=True)):
               engine "auto" -> chunked; layout facts and load seconds;
               pull(0, 7) bit-equal to the oracle
  12. chunked  the K6/K7 kernel against its plain version and the oracle:
               ADDMIN on the SSSP layout, MULADD and ANDOR on googleplus
               through engine="pallas"; PageRank.pull(0.9, 10) and
               BFS.pull(0, 7) on googleplus at scale 0.1 (engine "auto" ->
               chunked)
  13. times    the chunked kernel and its plain version (ADDMIN, MULADD,
               ANDOR), SSSP pull(0, 7) ms, the chunked MULADD engine call
               against the roll router's fused call on the same graph

The launch counters are set to 0 right before each path's app runs
(phases 4-5, 8, 11 and 12) and read right after; every kernel of the path
must have run there. Then it prints the kernels' JSON line and, last,
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0
and the ok line is not printed.

Usage: python3 chip_smoke.py [--scale S]   (S < 1 shrinks both graphs)
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
ROUTER_SRC = "graphlily_tpu_torch/csrc/router_spmv.cu"
PLANAR_SRC = "graphlily_tpu_torch/csrc/planar_spmv.cu"
CHUNKED_SRC = "graphlily_tpu_torch/csrc/chunked_spmv.cu"
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "K1_router_fused": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:419"),
    "K2_router_scatter": (ROUTER_SRC,
                          "graphlily_tpu/ops/router_pallas.py:368"),
    "K3_router_reduce": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:756"),
    "K4_planar_fused": (PLANAR_SRC, "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4_planar_scatter": (PLANAR_SRC,
                          "graphlily_tpu/ops/router_pallas.py:1398"),
    "K5_planar_xperm": (PLANAR_SRC, "graphlily_tpu/ops/router_pallas.py:924"),
    # one kernel for both chunked launchers: K7 (resident) and K6 (streamed)
    "K6_K7_chunked": (CHUNKED_SRC,
                      "graphlily_tpu/ops/spmv_pallas.py:294 (K7), "
                      "graphlily_tpu/ops/spmv_pallas.py:160 (K6)"),
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


def bit_equal(torch, label: str, a, b) -> None:
    if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                             b.view(torch.int32)):
        raise AssertionError(f"{label} differs from its plain version")


def reset(engines) -> None:
    for eng in engines:
        eng.launches = dict.fromkeys(eng.launches, 0)


def gteps(nnz: int, ms: float) -> str:
    return f"{nnz / ms / 1e6:.2f} GTEPS"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="graph scale (1.0 = the full stand-ins)")
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
    from graphlily_tpu_torch.ops import _build

    t_start = time.perf_counter()
    # ---- 1. card --------------------------------------------------------
    card = card_line()
    log("phase 1 card (nvidia-smi name, power.limit):")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1 tf32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in _build.library_paths())})")

    rec = {name: {} for name in KERNELS}
    gp = googleplus(torch, args, rec, card)
    pokec(torch, args, rec, card)
    chunked(torch, args, rec, card, gp)

    for name, r in rec.items():
        if r.get("launches", 0) == 0:
            raise AssertionError(f"{name} was not launched on an app path")
    kernels = [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": r["launches"],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
    } for name, r in rec.items()]
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def googleplus(torch, args, rec: dict, card: str) -> dict:
    """Phases 3-6: the roll router on the googleplus stand-in. Returns the
    graph, its degree-sorted form and the roll engine with its MULADD x,
    for the chunked phases."""
    from graphlily_tpu_torch import (EngineConfig, ArithmeticSemiring,
                                     LogicalSemiring)
    from graphlily_tpu_torch.apps import PageRank, BFS
    from graphlily_tpu_torch.io import (iccad_standin, ICCAD_GRAPHS,
                                        degree_sort_permutation,
                                        symmetric_permute,
                                        util_round_csr_matrix_dim)
    from graphlily_tpu_torch.module import SpMVModule
    dev = torch.device("cuda")

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
        bit_equal(torch, f"{semiring.name}: K2 stream", s2, s2p)
        for label, y in (("K1", y1), ("K1 plain", y1p), ("K3 (K2->K3)", y3),
                         ("K3 plain", y3p), ("engine call", mod.apply(xt))):
            y = y.cpu().numpy()
            if exact:
                y = (y != 0).astype(np.float64)
            err = check_close(f"{semiring.name} {label}", y, want, exact)
            log(f"phase 3 {semiring.name} {label}: max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        if not exact:
            rec["K1_router_fused"]["err"] = float((y1 - y1p).abs().max())
            rec["K2_router_scatter"]["err"] = float((s2 - s2p).abs().max())
            rec["K3_router_reduce"]["err"] = float((y3 - y3p).abs().max())
            spmv_eng, spmv_x = eng, xt
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
    reset((pr_eng, bfs_eng))
    rank = pr.pull(0.9, 10)
    dist_fused = bfs.pull(0, iters)
    bfs_eng.fused = False          # the split branch, through the same API
    dist_split = bfs.pull(0, iters)
    bfs_eng.fused = True
    torch.cuda.synchronize()
    rec["K1_router_fused"]["launches"] = (pr_eng.launches["fused"]
                                          + bfs_eng.launches["fused"])
    rec["K2_router_scatter"]["launches"] = bfs_eng.launches["scatter"]
    rec["K3_router_reduce"]["launches"] = bfs_eng.launches["reduce"]
    log(f"phase 4-5 launches: pagerank {pr_eng.launches} bfs "
        f"{bfs_eng.launches}")
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
    eng, xt = spmv_eng, spmv_x
    nnz = eng.nnz
    stream = eng.scatter(xt)
    timed = {
        "K1_router_fused": (lambda: eng.fused_spmv(xt),
                            lambda: eng.fused_plain(xt)),
        "K2_router_scatter": (lambda: eng.scatter(xt),
                              lambda: eng.scatter_plain(xt)),
        "K3_router_reduce": (lambda: eng.reduce(stream),
                             lambda: eng.reduce_plain(stream)),
    }
    for name, (kernel, plain) in timed.items():
        rec[name]["ms"] = time_ms(torch, kernel)
        rec[name]["plain_ms"] = time_ms(torch, plain)
    spmv_ms = time_ms(torch, lambda: eng(xt))
    split_ms = time_ms(torch, lambda: eng.reduce(eng.scatter(xt)))
    pr_ms = time_ms(torch, lambda: pr.pull(0.9, 100, device_output=True),
                    iters=1, reps=3) / 100
    bfs_ms = time_ms(torch, lambda: bfs.pull(0, iters, device_output=True),
                     iters=5, reps=3)
    for name in timed:
        ms, plain_ms = rec[name]["ms"], rec[name]["plain_ms"]
        log(f"phase 6 {name}: {ms:.4f} ms ({gteps(nnz, ms)}) plain "
            f"{plain_ms:.4f} ms ({gteps(nnz, plain_ms)})")
    log(f"phase 6 spmv engine call (fused): {spmv_ms:.4f} ms "
        f"({gteps(nnz, spmv_ms)}); split K2->K3 {split_ms:.4f} ms "
        f"({gteps(nnz, split_ms)})")
    log(f"phase 6 pagerank: {pr_ms:.4f} ms/iter; bfs pull({iters}): "
        f"{bfs_ms:.4f} ms; card {card}")
    return {"g": g, "gs": gs, "roll": spmv_eng, "x": spmv_x}


def pokec(torch, args, rec: dict, card: str) -> None:
    """Phases 7-10: the planar router on the pokec stand-in."""
    from graphlily_tpu_torch import EngineConfig
    from graphlily_tpu_torch.apps import PageRank, BFS
    from graphlily_tpu_torch.io import iccad_standin, ICCAD_GRAPHS
    dev = torch.device("cuda")
    iters = ICCAD_GRAPHS["pokec"]["iters"]

    # ---- 7. graph and layouts ----------------------------------------------
    t0 = time.perf_counter()
    g = iccad_standin("pokec", scale=args.scale, seed=0)
    log(f"phase 7 graph: pokec stand-in scale={args.scale} rows={g.num_rows} "
        f"nnz={g.nnz} ({time.perf_counter() - t0:.1f} s)")
    # the auto ladder picks the planar router at full size (nnz >= 2M,
    # epg < 200); a shrunken graph is denser per page and asks for it by
    # name
    engine = "auto" if args.scale >= 1 else "planar"
    apps = {}
    for key, app_cls, deal in (("pagerank", PageRank, "free"),
                               ("bfs", BFS, "free"),
                               ("bfs_bucket", BFS, "bucket")):
        t0 = time.perf_counter()
        app = app_cls(EngineConfig(sort_rows_by_degree=True, engine=engine,
                                   planar_deal=deal))
        if app_cls is PageRank:
            app.load_and_format_matrix(g, 0.9)
        else:
            app.load_and_format_matrix(g)
        secs = time.perf_counter() - t0
        mod = app.SpMV_
        eng = mod.engine
        if mod.engine_name != "planar" or not eng.fused:
            raise AssertionError(f"pokec {key} resolved {mod.engine_name!r}"
                                 f" (fused={getattr(eng, 'fused', None)}), "
                                 "not fused planar")
        w2 = eng.arrays.rg[..., 1]
        log(f"phase 7 pokec {key} layout (deal={deal}, scale={args.scale}): "
            f"relabel+pack+init {secs:.1f} s region_rows={eng.region_rows} "
            f"regions={eng.num_regions} cb={eng.cb} dstep={eng.dstep} "
            f"f={eng.f} nsteps={eng.nsteps} slots={eng.num_slots} "
            f"pieces={int((w2[:, :eng.dstep] > 0).sum())} "
            f"flushes={int((w2 < 0).sum())} "
            f"stream_MB={eng.nsteps * eng.f * 4096 / 1e6:.1f} "
            f"y_MB={eng.out_len * 4 / 1e6:.2f} fused={eng.fused}")
        apps[key] = app
    pr, bfs, bfsb = apps["pagerank"], apps["bfs"], apps["bfs_bucket"]
    pr_eng, bfs_eng = pr.SpMV_.engine, bfs.SpMV_.engine
    bfsb_eng = bfsb.SpMV_.engine

    # ---- 8. main path: PageRank and BFS through the public API ------------
    reset((pr_eng, bfs_eng, bfsb_eng))
    rank = pr.pull(0.9, 10)
    dist_fused = bfs.pull(0, iters)
    bfs_eng.fused = False          # the split branch, through the same API
    dist_split = bfs.pull(0, iters)
    bfs_eng.fused = True
    dist_bucket = bfsb.pull(0, iters)
    torch.cuda.synchronize()
    engines = (pr_eng, bfs_eng, bfsb_eng)
    rec["K4_planar_fused"]["launches"] = sum(e.launches["fused"]
                                             for e in engines)
    rec["K4_planar_scatter"]["launches"] = bfs_eng.launches["scatter"]
    rec["K3_router_reduce"]["launches"] += bfs_eng.launches["reduce"]
    rec["K5_planar_xperm"]["launches"] = bfsb_eng.launches["xperm"]
    log(f"phase 8 launches: pagerank {pr_eng.launches} bfs "
        f"{bfs_eng.launches} bfs bucket {bfsb_eng.launches}")
    err = check_close("pokec pagerank", rank,
                      pr.compute_reference_results(0.9, 10), exact=False)
    log(f"phase 8 pagerank pull(0.9, 10): engine=planar fused "
        f"max|r-r64|={err:.3e} ok")
    want = bfs.compute_reference_results(0, iters)
    check_close("pokec bfs fused", dist_fused, want, exact=True)
    check_close("pokec bfs split", dist_split, want, exact=True)
    log(f"phase 8 bfs pull(0, {iters}): fused and split equal the oracle "
        f"({int((want > 0).sum())} reached) ok")
    check_close("pokec bfs bucket", dist_bucket, want, exact=True)
    log(f"phase 8 bfs pull(0, {iters}) deal=bucket: equal to the oracle "
        f"({int((want > 0).sum())} reached) ok")

    # ---- 9. kernels vs plain versions, on the apps' engines ---------------
    rng = np.random.default_rng(1)
    for label, app in (("MULADD", pr), ("ANDOR", bfs)):
        mod, eng = app.SpMV_, app.SpMV_.engine
        exact = label == "ANDOR"
        if exact:
            x = (rng.random(eng.num_cols) < 0.05).astype(np.float32)
        else:
            x = rng.random(eng.num_cols).astype(np.float32)
        xt = torch.from_numpy(x).to(dev)
        want = mod.compute_reference_results(x)
        y4 = eng.fused_spmv(xt)
        y4p = eng.fused_plain(xt)
        s4 = eng.scatter(xt)
        s4p = eng.scatter_plain(xt)
        y3 = eng.reduce(s4)
        y3p = eng.reduce_plain(s4)
        torch.cuda.synchronize()
        bit_equal(torch, f"pokec {label}: K4 stream", s4, s4p)
        for name, y in (("K4 fused", y4), ("K4 fused plain", y4p),
                        ("K3 (K4->K3)", y3), ("K3 plain", y3p)):
            y = y.cpu().numpy()
            if exact:
                y = (y != 0).astype(np.float64)
            err = check_close(f"pokec {label} {name}", y, want, exact)
            log(f"phase 9 {label} {name}: max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        log(f"phase 9 {label}: K4 stream bit-equal to plain; ok")
        if not exact:
            rec["K4_planar_fused"]["err"] = float((y4 - y4p).abs().max())
            rec["K4_planar_scatter"]["err"] = float((s4 - s4p).abs().max())
            rec["K3_router_reduce"]["err"] = max(
                rec["K3_router_reduce"]["err"], float((y3 - y3p).abs().max()))
            spmv_x = xt
    xb = torch.from_numpy(rng.random(bfsb_eng.num_cols).astype(
        np.float32)).to(dev)
    x2, x2p = bfsb_eng.xperm(xb), bfsb_eng.xperm_plain(xb)
    torch.cuda.synchronize()
    bit_equal(torch, "pokec K5 x2", x2, x2p)
    rec["K5_planar_xperm"]["err"] = float((x2 - x2p).abs().max())
    sb, sbp = bfsb_eng.scatter(xb), bfsb_eng.scatter_plain(xb)
    torch.cuda.synchronize()
    bit_equal(torch, "pokec bucket K5 -> K4 stream", sb, sbp)
    log("phase 9 bucket: K5 x2 and K5 -> K4 stream bit-equal to plain; ok")

    # ---- 10. times ----------------------------------------------------------
    eng, xt = pr_eng, spmv_x
    nnz = eng.nnz
    stream = eng.scatter(xt)
    timed = {
        "K4_planar_fused": (lambda: eng.fused_spmv(xt),
                            lambda: eng.fused_plain(xt)),
        "K4_planar_scatter": (lambda: eng.scatter(xt),
                              lambda: eng.scatter_plain(xt)),
        "K3_router_reduce": (lambda: eng.reduce(stream),
                             lambda: eng.reduce_plain(stream)),
        "K5_planar_xperm": (lambda: bfsb_eng.xperm(xb),
                            lambda: bfsb_eng.xperm_plain(xb)),
    }
    for name, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        if name != "K3_router_reduce":   # K3's entry keeps googleplus' times
            rec[name]["ms"], rec[name]["plain_ms"] = ms, plain_ms
        rate = ("" if name == "K5_planar_xperm"
                else f" ({gteps(nnz, ms)}; plain {gteps(nnz, plain_ms)})")
        log(f"phase 10 pokec {name}: {ms:.4f} ms plain {plain_ms:.4f} ms"
            f"{rate}")
    spmv_ms = time_ms(torch, lambda: eng(xt))
    eng.fused = False
    split_ms = time_ms(torch, lambda: eng(xt))
    eng.fused = True
    xs = torch.from_numpy((rng.random(bfsb_eng.num_cols) < 0.05).astype(
        np.float32)).to(dev)
    bucket_ms = time_ms(torch, lambda: bfsb_eng(xs))
    pr_ms = time_ms(torch, lambda: pr.pull(0.9, 100, device_output=True),
                    iters=1, reps=3) / 100
    bfs_ms = time_ms(torch, lambda: bfs.pull(0, iters, device_output=True),
                     iters=5, reps=3)
    log(f"phase 10 pokec planar engine call: fused {spmv_ms:.4f} ms "
        f"({gteps(nnz, spmv_ms)}); split K4->K3 {split_ms:.4f} ms "
        f"({gteps(nnz, split_ms)}); bucket ANDOR (K5 + K4 fused) "
        f"{bucket_ms:.4f} ms ({gteps(bfsb_eng.nnz, bucket_ms)})")
    log(f"phase 10 pokec pagerank: {pr_ms:.4f} ms/iter; bfs pull({iters}): "
        f"{bfs_ms:.4f} ms; card {card}")


def chunked(torch, args, rec: dict, card: str, gp: dict) -> None:
    """Phases 11-13: SSSP and the small-graph apps on the chunked engine."""
    from graphlily_tpu_torch import (EngineConfig, ArithmeticSemiring,
                                     LogicalSemiring, FLOAT_INF)
    from graphlily_tpu_torch.apps import SSSP, PageRank, BFS
    from graphlily_tpu_torch.io import iccad_standin, ICCAD_GRAPHS
    from graphlily_tpu_torch.module import SpMVModule
    dev = torch.device("cuda")
    iters = ICCAD_GRAPHS["googleplus"]["iters"]
    inf = float(FLOAT_INF)

    # ---- 11. main path: SSSP through the public API -------------------------
    t0 = time.perf_counter()
    sssp = SSSP(EngineConfig(sort_rows_by_degree=True))
    sssp.load_and_format_matrix(gp["g"])
    secs = time.perf_counter() - t0
    mod, eng = sssp.SpMV_, sssp.SpMV_.engine
    if mod.engine_name != "chunked":
        raise AssertionError(f"SSSP resolved {mod.engine_name!r}, not chunked")
    code = eng.arrays.code.long()
    per_window = torch.bincount(torch.div(code, eng.nct, rounding_mode="floor"),
                                minlength=eng.num_rows // 128).cpu().numpy()
    slots = eng.num_chunks * 1024
    top_row = int(np.diff(mod.csr_matrix_.adj_indptr.astype(np.int64)).max())
    log(f"phase 11 sssp layout (scale={args.scale}): relabel+self edges+pack"
        f"+init {secs:.1f} s nnz={eng.nnz} chunks={eng.num_chunks} "
        f"fill={eng.nnz / slots:.3f} col_tiles={eng.nct} "
        f"window_groups={eng.out_len // 1024} streams r/rows/vals MB="
        f"{slots / 1e6:.1f}/{slots / 1e6:.1f}/{4 * slots / 1e6:.1f} "
        f"windows_with_chunks={int((per_window > 0).sum())}/{len(per_window)}"
        f" median_window_chunks={int(np.median(per_window[per_window > 0]))}"
        f" window0_chunks={int(per_window[0])} top_row_nnz={top_row}")
    reset((eng,))
    dist = sssp.pull(0, iters)
    torch.cuda.synchronize()
    rec["K6_K7_chunked"]["launches"] = eng.launches["chunked"]
    log(f"phase 11 launches: sssp {eng.launches}")
    want = sssp.compute_reference_results(0, iters)
    check_close("sssp", dist, want, exact=True)
    log(f"phase 11 sssp pull(0, {iters}): engine=chunked, equal to the "
        f"oracle ({int((want < inf).sum())} reached) ok")

    # ---- 12. the kernel against its plain version and the oracle ------------
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1000, eng.num_cols).astype(np.float32)
    x[rng.random(eng.num_cols) < 0.5] = inf    # integers: exact fp32 sums
    xt_min = torch.from_numpy(x).to(dev)
    y, yp = eng.spmv(xt_min), eng.spmv_plain(xt_min)
    torch.cuda.synchronize()
    bit_equal(torch, "ADDMIN chunked kernel", y, yp)
    want = mod.compute_reference_results(x)
    for label, out in (("kernel", y), ("plain", yp),
                       ("engine call", mod.apply(xt_min))):
        check_close(f"ADDMIN chunked {label}", out.cpu().numpy(), want,
                    exact=True)
    rec["K6_K7_chunked"]["err"] = float((y - yp).abs().max())
    log("phase 12 ADDMIN (SSSP layout): kernel bit-equal to plain; kernel, "
        "plain and engine call equal to the oracle; ok")
    engines = {}
    for semiring in (ArithmeticSemiring, LogicalSemiring):
        t0 = time.perf_counter()
        m = SpMVModule(EngineConfig(engine="pallas", device="cuda"))
        m.set_semiring(semiring)
        m.load_and_format_matrix(gp["gs"])
        e = m.engine
        assert m.engine_name == "chunked", m.engine_name
        exact = semiring is LogicalSemiring
        if exact:
            xs = (rng.random(e.num_cols) < 0.05).astype(np.float32)
        else:
            xs = rng.random(e.num_cols).astype(np.float32)
        xt = torch.from_numpy(xs).to(dev)
        want = m.compute_reference_results(xs)
        y, yp = e.spmv(xt), e.spmv_plain(xt)
        torch.cuda.synchronize()
        if exact:
            bit_equal(torch, "ANDOR chunked kernel", y, yp)
        for label, out in (("kernel", y), ("plain", yp),
                           ("engine call", m.apply(xt))):
            out = out.cpu().numpy()
            if exact:
                out = (out != 0).astype(np.float64)
            err = check_close(f"{semiring.name} chunked {label}", out, want,
                              exact)
            log(f"phase 12 {semiring.name} chunked {label} (googleplus, "
                f"engine=pallas, pack+init {time.perf_counter() - t0:.1f} s,"
                f" {e.num_chunks} chunks): max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        engines[semiring.name] = (m, e, xt)
    small = iccad_standin("googleplus", scale=0.1 * args.scale, seed=0)
    cfg = EngineConfig(sort_rows_by_degree=True)
    pr, bfs = PageRank(cfg), BFS(cfg)
    pr.load_and_format_matrix(small, 0.9)
    bfs.load_and_format_matrix(small)
    for app in (pr, bfs):
        if app.SpMV_.engine_name != "chunked":
            raise AssertionError(f"{type(app).__name__} on {small.nnz} edges "
                                 f"resolved {app.SpMV_.engine_name!r}")
    reset((pr.SpMV_.engine, bfs.SpMV_.engine))
    rank = pr.pull(0.9, 10)
    dist = bfs.pull(0, iters)
    torch.cuda.synchronize()
    log(f"phase 12 launches: pagerank {pr.SpMV_.engine.launches} bfs "
        f"{bfs.SpMV_.engine.launches}")
    if min(pr.SpMV_.engine.launches["chunked"],
           bfs.SpMV_.engine.launches["chunked"]) == 0:
        raise AssertionError("the small-graph apps did not launch the kernel")
    err = check_close("small pagerank", rank,
                      pr.compute_reference_results(0.9, 10), exact=False)
    want = bfs.compute_reference_results(0, iters)
    check_close("small bfs", dist, want, exact=True)
    log(f"phase 12 googleplus scale {0.1 * args.scale:g} ({small.nnz} edges):"
        f" engine=chunked; pagerank pull(0.9, 10) max|r-r64|={err:.3e}; "
        f"bfs pull(0, {iters}) equal to the oracle "
        f"({int((want > 0).sum())} reached) ok")

    # ---- 13. times ------------------------------------------------------------
    ms = time_ms(torch, lambda: eng.spmv(xt_min))
    plain_ms = time_ms(torch, lambda: eng.spmv_plain(xt_min))
    rec["K6_K7_chunked"]["ms"], rec["K6_K7_chunked"]["plain_ms"] = ms, plain_ms
    log(f"phase 13 ADDMIN chunked kernel (SSSP layout): {ms:.4f} ms "
        f"({gteps(eng.nnz, ms)}) plain {plain_ms:.4f} ms "
        f"({gteps(eng.nnz, plain_ms)})")
    for name, (m, e, xt) in engines.items():
        k_ms = time_ms(torch, lambda: e.spmv(xt))
        p_ms = time_ms(torch, lambda: e.spmv_plain(xt))
        log(f"phase 13 {name} chunked kernel (googleplus): {k_ms:.4f} ms "
            f"({gteps(e.nnz, k_ms)}) plain {p_ms:.4f} ms "
            f"({gteps(e.nnz, p_ms)})")
    m, e, _ = engines["arithmetic"]
    roll, xt = gp["roll"], gp["x"]
    chunked_ms = time_ms(torch, lambda: m.apply(xt))
    roll_ms = time_ms(torch, lambda: roll(xt))
    sssp_ms = time_ms(torch, lambda: sssp.pull(0, iters, device_output=True),
                      iters=5, reps=3)
    log(f"phase 13 MULADD engine call on the same googleplus graph: chunked "
        f"{chunked_ms:.4f} ms ({gteps(e.nnz, chunked_ms)}), roll router fused "
        f"{roll_ms:.4f} ms ({gteps(roll.nnz, roll_ms)})")
    log(f"phase 13 sssp pull(0, {iters}): {sssp_ms:.4f} ms; ADDMIN engine "
        f"call {time_ms(torch, lambda: eng(xt_min)):.4f} ms; card {card}")


if __name__ == "__main__":
    sys.exit(main())
