#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphlily_tpu_torch) on one GPU.

Drives the port's main paths once, through the entry points a user
calls, and checks every result against the float64 oracles:

  * the googleplus stand-in (RMAT, 107,614 vertices, 13,673,453 edges,
    seed 0, degree-sorted) through the roll router (K1, K2, K3);
  * the pokec stand-in (RMAT, 1,632,803 vertices, 30,622,564 edges,
    seed 0, degree-sorted) through the planar router (K4 fused, K4
    scatter -> K3, and K5 under planar_deal="bucket" on a quarter of
    it);
  * SSSP on the googleplus stand-in (self edges added: 13,780,368 nnz),
    through the chunked engine (the K6/K7 kernel), and PageRank and BFS
    on the googleplus stand-in at scale 0.1, which the ladder also sends
    to the chunked engine;
  * push and pull_push (SpMSpV) of BFS on both stand-ins and of SSSP on
    googleplus, through the frontier-predicated kernels: K1p, K2p -> K3p
    (roll), K4p fused and K4p scatter -> K3p (planar), K7p (chunked);
  * SSSP pull, push and pull_push on the pokec stand-in (self edges
    added: 32,254,873 nnz), which the ladder sends to the tropical engine
    (K4 scatter and K4p scatter in ADDMIN mode, K8 split, K10 window
    reduce), and SSSP on half of the googleplus stand-in through the
    tropical engine by name in the "triples" split format (K9);
  * BFS pull, push and pull_push on the full pokec stand-in and PageRank
    on a quarter of it with planar_deal="permc" (PERM-C layouts, packed
    by the C++ greedy): K4 fused and K4p fused on PERM-C rows, K4 scatter
    -> K11 and K4p scatter -> K11p.

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
               third BFS packs the "bucket" deal on the stand-in at
               scale 0.25 (BUCKET_SCALE)
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
  14. push     googleplus BFS (the phase 4-5 app; SpMSpV shares its roll
               engine): push(0, 7) and pull_push(0, 7, threshold=0.05),
               fused (K1p) and split (K2p -> K3p), bit-equal to the oracle
  15. push     pokec BFS push(0, 11) and pull_push(0, 11) on the free deal,
               fused (K4p fused) and split (K4p scatter -> K3p), and push
               on the bucket deal (K5 -> K4p fused)
  16. push     googleplus SSSP (the phase 11 app; SpMSpV packs its own
               chunk_order="col" layout) push(0, 7) and pull_push(0, 7)
               (K7p, ADDMIN) and BFS push on googleplus at scale 0.1 (K7p,
               ANDOR); the col layout's chunks and the batches a 1-vertex
               frontier keeps
  17. kernels  each predicated kernel against its plain version and the
               unpredicated kernel for three frontiers (empty, 1 vertex,
               5% of the columns), and their times (CUDA events, min over
               5 reps of 100 calls); push and pull_push ms of each app with
               the pull_push_time_breakdown phase split
  18. sssp     pokec SSSP(EngineConfig(sort_rows_by_degree=True)): engine
               "auto" -> tropical, SpMSpV sharing it; layout facts, load
               and pack seconds; pull(0, 11), push(0, 11) and
               pull_push(0, 11, 0.05) bit-equal to the oracle
  19. kernels  pokec: K4 scatter ADDMIN's stream, K8's window stream and
               K10's maxima bit-equal to their plain versions; K4p scatter
               ADDMIN against its plain version and the unpredicated
               scatter at empty, 1-vertex and 5% frontiers; googleplus
               SSSP at scale 0.5 (TRIPLES_SCALE: cut from the full graph
               to keep the whole run near 750 s) with
               engine="router", tropical_split_format="triples": pull(0, 7)
               and push(0, 7) against the oracle, K9 bit-equal to its plain
               version, the tropical and a chunked engine call on its
               matrix against the oracle
  20. times    the new kernels and their plain versions, bounds, the pokec
               tropical engine call, the googleplus tropical (triples)
               engine call against the chunked engine call on the same
               matrix, pokec SSSP pull, push and pull_push ms and the
               pull_push_time_breakdown phase split
  21. permc    pokec BFS(EngineConfig(sort_rows_by_degree=True,
               planar_deal="permc")) on the full graph (engine "auto" ->
               planar; SpMSpV shares it): g++ build, C++ greedy, pack and
               load seconds, layout facts (row runs, elements a run);
               pull(0, 11) fused and split, push(0, 11) fused and split,
               pull_push(0, 11, 0.05) bit-equal to the oracle; PageRank
               pull(0.9, 10) on PERM-C on the quarter graph of phase 7; a
               MULADD engine on BFS's layout: K4 fused PERM-C and K4
               scatter -> K11 against their plain versions and the
               float64 oracle; ANDOR K11 and K4 fused bit-equal to plain;
               K11p and K4p fused PERM-C at empty, 1-vertex and 5%
               frontiers bit-equal to plain and unpredicated, MULADD at 5%
  22. times    K11, K11p, K4 fused and K4p fused PERM-C against their plain
               versions and bounds; torch.mv on BFS's matrix; the PERM-C
               engine call fused and split against the free deal's fused
               call (phase 10's engine); BFS pull, push and pull_push ms,
               PageRank ms/iter

The launch counters are set to 0 right before each path's app runs
(phases 4-5, 8, 11, 12, 14-16, 18, 19's googleplus SSSP and 21) and read
right after; every kernel of the path must have run there. Then it prints the kernels' JSON line: per
kernel its launches on the app paths, its largest difference from its
plain version, its time, its plain version's, its bound (the larger of
the bytes it must move over 3.35 TB/s and its fp32 operations over
67 TFLOP/s, the H100 SXM's published peaks, counted from this run's
inputs; a predicated kernel's from its 5% frontier; the tropical
kernels' max_abs_err on their int32 encodings decoded to floats) and, for
the MULADD
SpMVs, the time of `torch.mv` on a CSR tensor of the same matrix (cuSPARSE;
timed here, never used by the port). Last comes {"ok": true, "device":
{...}}. Any failure raises: the exit code is not 0 and the ok line is not
printed.

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
TROPICAL_SRC = "graphlily_tpu_torch/csrc/tropical_spmv.cu"
PERMC_SRC = "graphlily_tpu_torch/csrc/permc_spmv.cu"
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
    # the frontier-predicated forms (SpMSpV): the Pallas launchers with sm/na
    "K7p_chunked_pred": (CHUNKED_SRC, "graphlily_tpu/ops/spmv_pallas.py:335"),
    "K1p_router_fused_pred": (ROUTER_SRC,
                              "graphlily_tpu/ops/router_pallas.py:419"),
    "K2p_router_scatter_pred": (ROUTER_SRC,
                                "graphlily_tpu/ops/router_pallas.py:368"),
    "K3p_router_reduce_pred": (ROUTER_SRC,
                               "graphlily_tpu/ops/router_pallas.py:756"),
    "K4p_planar_fused_pred": (PLANAR_SRC,
                              "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4p_planar_scatter_pred": (PLANAR_SRC,
                                "graphlily_tpu/ops/router_pallas.py:1398"),
    # the tropical engine: K4 scatter's and K4p scatter's ADDMIN instances
    # (int32 encodings), the split in its two formats, the window reduce
    "K4_planar_scatter_addmin": (PLANAR_SRC,
                                 "graphlily_tpu/ops/router_pallas.py:1398"),
    "K4p_planar_scatter_pred_addmin": (
        PLANAR_SRC, "graphlily_tpu/ops/router_pallas.py:1398"),
    "K8_tropical_split": (TROPICAL_SRC,
                          "graphlily_tpu/ops/tropical_pallas.py:137"),
    "K9_tropical_split_triples": (TROPICAL_SRC,
                                  "graphlily_tpu/ops/tropical_pallas.py:301"),
    "K10_tropical_window_reduce": (TROPICAL_SRC,
                                   "graphlily_tpu/ops/tropical_pallas.py:392"),
    # PERM-C: the split branch's run-sum reduce and its predicated launch
    # (sm/na), and K4 fused's PERM-C instance (permc=True, with beg)
    "K11_permc_reduce": (PERMC_SRC, "graphlily_tpu/ops/router_pallas.py:851"),
    "K11p_permc_reduce_pred": (PERMC_SRC,
                               "graphlily_tpu/ops/router_pallas.py:851"),
    "K4_planar_fused_permc": (PLANAR_SRC,
                              "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4p_planar_fused_pred_permc": (
        PLANAR_SRC, "graphlily_tpu/ops/router_pallas.py:1459"),
}
BUCKET_SCALE = 0.25  # the pokec stand-in's cut for the "bucket" deal (K5)
TRIPLES_SCALE = 0.5  # the googleplus stand-in's cut for the "triples" SSSP
MULADD_RTOL = 1e-4   # fp32 atomics in any order over hub rows of ~1e5 terms
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks at 700 W
FP32_OPS_PER_S = 67e12


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
    """Launch counters to 0, in place: the tropical engine shares its dict
    with its pass-1 planar engine."""
    for eng in engines:
        for key in eng.launches:
            eng.launches[key] = 0


def gteps(nnz: int, ms: float) -> str:
    return f"{nnz / ms / 1e6:.2f} GTEPS"


def set_bound(r: dict, nbytes: float, nops: float) -> None:
    """The least time the card could take: bytes over the memory rate or
    fp32 operations over the peak rate, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_OPS_PER_S * 1e3
    r["bound_ms"], r["bound_by"] = (tb, "bytes") if tb >= to else (
        to, "operations")
    r["bound_bytes"] = nbytes


def router_traffic(eng, act=None) -> dict:
    """What a roll or planar kernel must move on this run's input, from
    the layout: A-stream bytes of the real entries it reads (int8 lane,
    fp32 value, int8 sublane where the layout has one; padding slots are
    not counted) and one page word per chunk read, elements deposited,
    flush chunks reduced, deposit-slot words and x/y. `act` (the
    frontier's activity) restricts it to the live work."""
    a = eng.arrays
    per_slot = 5 + (a.a_sub is not None)
    units = eng.chunk_units()
    slots = eng.nsteps * eng.dstep
    if act is None:
        chunks, elems = units.numel(), eng.nnz
        live = int((a.c_code >= 0).sum())
        x_bytes = 4 * eng.num_cols
    else:
        on = act.bool()
        chunks = int(on[units].sum())
        elems = int(on[eng.plain_index()["unit"]].sum())
        live = int(eng.live_chunks(act).sum())
        x_bytes = 4 * eng.ACT_COLS * int(on.sum())
    desc = slots * (12 + (32 if hasattr(a, "tri") else 0))
    return dict(a=elems * per_slot + 4 * chunks, elems=elems, live=live,
                desc=desc, x=x_bytes, y=4 * eng.out_len,
                stream=4 * eng.nsteps * eng.f * 1024)


def router_bounds(eng, act=None) -> dict:
    """(bytes, ops) of the fused, scatter and reduce kernels."""
    t = router_traffic(eng, act)
    return {
        "fused": (t["a"] + t["desc"] + 2 * t["elems"] + t["x"] + t["y"],
                  2 * t["elems"]),
        "scatter": (t["a"] + t["desc"] + t["x"] + t["stream"], t["elems"]),
        "reduce": (t["live"] * 1024 * 6 + t["y"], t["elems"]),
    }


def library_mv(torch, csr, xt, want: np.ndarray) -> float:
    """ms of `torch.mv` on a CSR tensor of `csr` (cuSPARSE), the one
    PyTorch call that computes the same MULADD SpMV; checked against the
    float64 oracle first."""
    nnz = csr.nnz
    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.adj_indptr.astype(np.int64)),
        torch.from_numpy(csr.adj_indices[:nnz].astype(np.int64)),
        torch.from_numpy(csr.adj_data[:nnz].astype(np.float32)),
        size=(csr.num_rows, csr.num_cols)).to(xt.device)
    x = xt[:csr.num_cols]
    check_close("library torch.mv", torch.mv(a, x).cpu().numpy(), want,
                exact=False)
    return time_ms(torch, lambda: torch.mv(a, x))


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

    rec = {name: {"library_ms": None} for name in KERNELS}
    gp = googleplus(torch, args, rec, card)
    pk = pokec(torch, args, rec, card)
    ch = chunked(torch, args, rec, card, gp)
    push_paths(torch, args, gp, pk, ch, rec)
    predicated_kernels(torch, rec, card, gp, pk, ch)
    tropical(torch, args, rec, card, pk)
    permc(torch, args, rec, card, pk)

    for name, r in rec.items():
        if r.get("launches", 0) == 0:
            raise AssertionError(f"{name} was not launched on an app path")
    kernels = [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": r["launches"],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, r in rec.items()]
    for k in kernels:
        log(f"bound {k['name']}: {k['ms']:.4f} ms against a bound of "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}, "
            f"{rec[k['name']]['bound_bytes'] / 1e6:.1f} MB); library "
            f"{k['library_ms']}")
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
            spmv_eng, spmv_x, spmv_mod = eng, xt, mod
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
    for name, (nbytes, nops) in zip(timed, router_bounds(eng).values()):
        set_bound(rec[name], nbytes, nops)
    rec["K1_router_fused"]["library_ms"] = library_mv(
        torch, gs, xt, spmv_mod.compute_reference_results(xt.cpu().numpy()))
    log(f"phase 6 library torch.mv (CSR, cuSPARSE) on the same MULADD "
        f"SpMV: {rec['K1_router_fused']['library_ms']:.4f} ms")
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
    return {"g": g, "gs": gs, "roll": spmv_eng, "x": spmv_x, "bfs": bfs,
            "library_ms": rec["K1_router_fused"]["library_ms"]}


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
    # the "bucket" deal (K5) runs on a quarter of the stand-in, to keep the
    # whole run near 600 s once the tropical pack joined it; the planar
    # engine is asked for by name there
    gb = iccad_standin("pokec", scale=BUCKET_SCALE * args.scale, seed=0)
    apps = {}
    for key, app_cls, deal, graph, eng_name, scale in (
            ("pagerank", PageRank, "free", g, engine, args.scale),
            ("bfs", BFS, "free", g, engine, args.scale),
            ("bfs_bucket", BFS, "bucket", gb, "planar",
             BUCKET_SCALE * args.scale)):
        t0 = time.perf_counter()
        app = app_cls(EngineConfig(sort_rows_by_degree=True, engine=eng_name,
                                   planar_deal=deal))
        if app_cls is PageRank:
            app.load_and_format_matrix(graph, 0.9)
        else:
            app.load_and_format_matrix(graph)
        secs = time.perf_counter() - t0
        mod = app.SpMV_
        eng = mod.engine
        if mod.engine_name != "planar" or not eng.fused:
            raise AssertionError(f"pokec {key} resolved {mod.engine_name!r}"
                                 f" (fused={getattr(eng, 'fused', None)}), "
                                 "not fused planar")
        w2 = eng.arrays.rg[..., 1]
        log(f"phase 7 pokec {key} layout (deal={deal}, scale={scale:g}, "
            f"{graph.nnz} edges): "
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
    want_b = bfsb.compute_reference_results(0, iters)
    check_close("pokec bfs bucket", dist_bucket, want_b, exact=True)
    log(f"phase 8 bfs pull(0, {iters}) deal=bucket (scale "
        f"{BUCKET_SCALE * args.scale:g}): equal to the oracle "
        f"({int((want_b > 0).sum())} reached) ok")

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
    bounds = router_bounds(eng)
    set_bound(rec["K4_planar_fused"], *bounds["fused"])
    set_bound(rec["K4_planar_scatter"], *bounds["scatter"])
    set_bound(rec["K5_planar_xperm"],
              bfsb_eng.num_col_tiles * 8 * 1024 + 8 * bfsb_eng.num_cols, 0)
    log(f"phase 10 pokec K3 bound on the planar stream: "
        f"{bounds['reduce'][0] / HBM_BYTES_PER_S * 1e3:.4f} ms")
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
    rec["K4_planar_fused"]["library_ms"] = library_mv(
        torch, pr.SpMV_.csr_matrix_, xt,
        pr.SpMV_.compute_reference_results(xt.cpu().numpy()))
    log(f"phase 10 pokec library torch.mv (CSR, cuSPARSE) on PageRank's "
        f"MULADD SpMV: {rec['K4_planar_fused']['library_ms']:.4f} ms")
    log(f"phase 10 pokec pagerank: {pr_ms:.4f} ms/iter; bfs pull({iters}): "
        f"{bfs_ms:.4f} ms; card {card}")
    return {"g": g, "gb": gb, "bfs": bfs, "bfsb": bfsb, "pr": pr,
            "x": spmv_x}


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
    set_bound(rec["K6_K7_chunked"],
              chunked_bytes(eng, eng.num_chunks, eng.nnz), 2 * eng.nnz)
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
        f"{roll_ms:.4f} ms ({gteps(roll.nnz, roll_ms)}), library torch.mv "
        f"{gp['library_ms']:.4f} ms; chunked MULADD bound "
        f"{chunked_bytes(e, e.num_chunks, e.nnz) / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms")
    log(f"phase 13 sssp pull(0, {iters}): {sssp_ms:.4f} ms; ADDMIN engine "
        f"call {time_ms(torch, lambda: eng(xt_min)):.4f} ms; card {card}")
    return {"sssp": sssp, "bfs_small": bfs}


def chunked_bytes(eng, chunks: int, real: int,
                  x_tiles: int | None = None) -> int:
    """Bytes a chunked kernel must move: the streams of the `real` entries
    it folds (int8 lane, int8 row, fp32 value; padding slots are not
    counted), the codes of the chunks that hold them, x's tiles it reads
    and y once."""
    tiles = eng.nct if x_tiles is None else x_tiles
    return 6 * real + 4 * chunks + 4 * 1024 * tiles + 4 * eng.out_len


def frontier_x(torch, ncols: int, kind: str, zero: float, rng):
    """A dense frontier on the card: no entry, one column, or 5% of the
    columns active (integer values 1..1000: exact in any fp32 order), the
    semiring zero elsewhere."""
    k = {"empty": 0, "one": 1, "5pct": ncols // 20}[kind]
    x = np.full(ncols, zero, np.float32)
    x[rng.choice(ncols, size=k, replace=False)] = rng.integers(
        1, 1001, k).astype(np.float32)
    return torch.from_numpy(x).to("cuda")


def push_paths(torch, args, gp: dict, pk: dict, ch: dict, rec: dict) -> None:
    """Phases 14-16: push and pull_push through the public API, with the
    launch counters set to 0 just before each path and read just after."""
    from graphlily_tpu_torch.io import ICCAD_GRAPHS
    from graphlily_tpu_torch import FLOAT_INF

    # ---- 14. googleplus BFS push and pull_push (roll: K1p, K2p -> K3p) ------
    bfs = gp["bfs"]
    eng = bfs.SpMV_.engine
    if bfs.SpMSpV_.engine is not eng:
        raise AssertionError("googleplus BFS holds two copies of its engine")
    iters = ICCAD_GRAPHS["googleplus"]["iters"]
    want = bfs.compute_reference_results(0, iters)
    reset((eng,))
    runs = {"push fused": bfs.push(0, iters),
            "pull_push fused": bfs.pull_push(0, iters, threshold=0.05)}
    eng.fused = False
    runs["push split"] = bfs.push(0, iters)
    runs["pull_push split"] = bfs.pull_push(0, iters, threshold=0.05)
    eng.fused = True
    torch.cuda.synchronize()
    rec["K1p_router_fused_pred"]["launches"] = eng.launches["fused_pred"]
    rec["K2p_router_scatter_pred"]["launches"] = eng.launches["scatter_pred"]
    rec["K3p_router_reduce_pred"]["launches"] = eng.launches["reduce_pred"]
    log(f"phase 14 launches: googleplus bfs {eng.launches}")
    for label, dist in runs.items():
        check_close(f"googleplus bfs {label}", dist, want, exact=True)
    log(f"phase 14 googleplus bfs push(0, {iters}) and pull_push(0, {iters},"
        f" 0.05), fused and split: equal to the oracle "
        f"({int((want > 0).sum())} reached) ok")

    # ---- 15. pokec BFS push and pull_push (planar: K4p fused, K4p scatter) --
    bfs, bfsb = pk["bfs"], pk["bfsb"]
    eng, engb = bfs.SpMV_.engine, bfsb.SpMV_.engine
    for app in (bfs, bfsb):
        if app.SpMSpV_.engine is not app.SpMV_.engine:
            raise AssertionError("pokec BFS holds two copies of its engine")
    iters = ICCAD_GRAPHS["pokec"]["iters"]
    want = bfs.compute_reference_results(0, iters)
    reset((eng, engb))
    runs = {"push fused": bfs.push(0, iters),
            "pull_push fused": bfs.pull_push(0, iters, threshold=0.05)}
    eng.fused = False
    runs["push split"] = bfs.push(0, iters)
    runs["pull_push split"] = bfs.pull_push(0, iters, threshold=0.05)
    eng.fused = True
    dist_bucket = bfsb.push(0, iters)
    torch.cuda.synchronize()
    rec["K4p_planar_fused_pred"]["launches"] = (eng.launches["fused_pred"]
                                                + engb.launches["fused_pred"])
    rec["K4p_planar_scatter_pred"]["launches"] = eng.launches["scatter_pred"]
    rec["K3p_router_reduce_pred"]["launches"] += eng.launches["reduce_pred"]
    log(f"phase 15 launches: pokec bfs {eng.launches} bfs bucket "
        f"{engb.launches}")
    for label, dist in runs.items():
        check_close(f"pokec bfs {label}", dist, want, exact=True)
    check_close("pokec bfs push bucket", dist_bucket,
                bfsb.compute_reference_results(0, iters), exact=True)
    log(f"phase 15 pokec bfs push(0, {iters}) and pull_push(0, {iters}, "
        f"0.05), fused and split, and push on the bucket deal (scale "
        f"{BUCKET_SCALE * args.scale:g}): equal to the oracle "
        f"({int((want > 0).sum())} reached) ok")

    # ---- 16. googleplus SSSP push and pull_push (chunked: K7p) --------------
    sssp, small = ch["sssp"], ch["bfs_small"]
    seng, beng = sssp.SpMSpV_.engine, small.SpMSpV_.engine
    for e in (seng, beng):
        if not e.col_order:
            raise AssertionError("SpMSpV did not pack a chunk_order='col' "
                                 "layout")
    iters = ICCAD_GRAPHS["googleplus"]["iters"]
    act = seng.tile_activity(sssp._init_distance(sssp._internal_source(0)))
    log(f"phase 16 sssp SpMSpV layout (chunk_order=col): "
        f"chunks={seng.num_chunks} batches={seng.num_chunks // 32} "
        f"col_tiles={seng.nct}; a 1-vertex frontier keeps "
        f"{int(seng.kept_batches(act).sum())} batches, "
        f"{int(seng.active_chunks(act).sum())} chunks")
    want = sssp.compute_reference_results(0, iters)
    want_small = small.compute_reference_results(0, iters)
    reset((seng, beng))
    runs = {"push": sssp.push(0, iters), "pull_push": sssp.pull_push(0, iters)}
    dist_small = small.push(0, iters)
    torch.cuda.synchronize()
    rec["K7p_chunked_pred"]["launches"] = (seng.launches["chunked_pred"]
                                           + beng.launches["chunked_pred"])
    log(f"phase 16 launches: sssp SpMSpV {seng.launches} small bfs SpMSpV "
        f"{beng.launches}")
    for label, dist in runs.items():
        check_close(f"sssp {label}", dist, want, exact=True)
    check_close("small bfs push", dist_small, want_small, exact=True)
    log(f"phase 16 sssp push(0, {iters}) and pull_push(0, {iters}): equal to "
        f"the oracle ({int((want < float(FLOAT_INF)).sum())} reached); bfs "
        f"push(0, {iters}) at scale {0.1 * args.scale:g} on K7p (ANDOR) "
        f"equal to the oracle; ok")


def predicated_kernels(torch, rec: dict, card: str, gp: dict, pk: dict,
                       ch: dict) -> None:
    """Phase 17: each predicated kernel against its plain version and the
    unpredicated kernel for three frontiers, their times, and the push
    apps' times with their phase split."""
    from graphlily_tpu_torch import FLOAT_INF
    from graphlily_tpu_torch.io import ICCAD_GRAPHS
    rng = np.random.default_rng(17)
    inf = float(FLOAT_INF)

    def router_rows(label, eng, fused_name, scatter_name, reduce_name,
                    muladd_err=0.0):
        for kind in ("empty", "one", "5pct"):
            xt = frontier_x(torch, eng.num_cols, kind, 0.0, rng)
            act = eng.activity(xt)
            live = eng.live_chunks(act)
            s, sp = eng.scatter_predicated(xt, act), eng.scatter_plain(
                xt, None, act)
            y3, y3p = eng.reduce_predicated(s, live), eng.reduce_plain(
                s, None, live)
            y1, y1p = eng.fused_predicated(xt, act), eng.fused_plain(
                xt, None, act)
            full = eng.fused_spmv(xt)
            torch.cuda.synchronize()
            bit_equal(torch, f"{label} {kind} scatter", s, sp)
            for name, y, yp in (("fused", y1, y1p), ("reduce", y3, y3p)):
                bit_equal(torch, f"{label} {kind} {name}", y, yp)
                bit_equal(torch, f"{label} {kind} {name} vs unpredicated",
                          y, full)
            errs = {n: float((y - yp).abs().max()) for n, y, yp in (
                ("fused", y1, y1p), ("scatter", s, sp), ("reduce", y3, y3p))}
            times = {n: time_ms(torch, f) for n, f in (
                ("fused", lambda: eng.fused_predicated(xt, act)),
                ("scatter", lambda: eng.scatter_predicated(xt, act)),
                ("reduce", lambda: eng.reduce_predicated(s, live)))}
            bounds = {n: max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3
                      for n, (b, o) in router_bounds(eng, act).items()}
            log(f"phase 17 {label} {kind}: live deposits "
                f"{int(eng.live_deposits(act).sum())}, live flush chunks "
                f"{int(live.sum())}; fused_pred {times['fused']:.4f} ms "
                f"(bound {bounds['fused']:.6f}), scatter_pred "
                f"{times['scatter']:.4f} ms (bound {bounds['scatter']:.6f}), "
                f"reduce_pred {times['reduce']:.4f} ms (bound "
                f"{bounds['reduce']:.6f}); bit-equal to plain and to the "
                f"unpredicated kernels ok")
        full_ms = {n: time_ms(torch, f) for n, f in (
            ("fused", lambda: eng.fused_spmv(xt)),
            ("scatter", lambda: eng.scatter(xt)),
            ("reduce", lambda: eng.reduce(s)))}
        plain_ms = {n: time_ms(torch, f, iters=10) for n, f in (
            ("fused", lambda: eng.fused_plain(xt, None, act)),
            ("scatter", lambda: eng.scatter_plain(xt, None, act)),
            ("reduce", lambda: eng.reduce_plain(s, None, live)))}
        bounds = router_bounds(eng, act)
        for n, name in (("fused", fused_name), ("scatter", scatter_name),
                        ("reduce", reduce_name)):
            if name is None:
                continue
            r = rec[name]
            r["ms"], r["plain_ms"] = times[n], plain_ms[n]
            r["err"] = max(errs[n], muladd_err if n == "fused" else 0.0)
            set_bound(r, *bounds[n])
        log(f"phase 17 {label} 5%: unpredicated fused {full_ms['fused']:.4f}"
            f" ms, scatter {full_ms['scatter']:.4f} ms, reduce "
            f"{full_ms['reduce']:.4f} ms; plain fused_pred "
            f"{plain_ms['fused']:.4f} ms, scatter_pred "
            f"{plain_ms['scatter']:.4f} ms, reduce_pred "
            f"{plain_ms['reduce']:.4f} ms")

    # roll (K1p, K2p, K3p): MULADD on the phase 3 engine within the
    # tolerance, then ANDOR on the googleplus BFS engine bit for bit; K1p's
    # row takes the larger difference from plain
    roll = gp["roll"]
    xt = frontier_x(torch, roll.num_cols, "5pct", 0.0, rng)
    act = roll.activity(xt)
    y, yp, full = (roll.fused_predicated(xt, act),
                   roll.fused_plain(xt, None, act), roll.fused_spmv(xt))
    torch.cuda.synchronize()
    scale = float(yp.abs().max())
    for label, ref in (("plain", yp), ("unpredicated", full)):
        err = float((y - ref).abs().max())
        if err > MULADD_RTOL * scale:
            raise AssertionError(f"MULADD K1p vs {label}: {err} > "
                                 f"{MULADD_RTOL * scale}")
    muladd_err = float((y - yp).abs().max())
    log(f"phase 17 googleplus roll MULADD 5%: K1p within {muladd_err:.3e} "
        f"of plain (max|y| {scale:.6e}) ok")
    router_rows("googleplus roll ANDOR", gp["bfs"].SpMV_.engine,
                "K1p_router_fused_pred", "K2p_router_scatter_pred",
                "K3p_router_reduce_pred", muladd_err)
    # planar (K4p fused, K4p scatter -> K3p) on the pokec BFS engines
    router_rows("pokec planar free ANDOR", pk["bfs"].SpMV_.engine,
                "K4p_planar_fused_pred", "K4p_planar_scatter_pred", None)
    engb = pk["bfsb"].SpMV_.engine
    xt = frontier_x(torch, engb.num_cols, "5pct", 0.0, rng)
    act = engb.activity(xt)
    pairs = ((engb.fused_predicated(xt, act), engb.fused_plain(xt, None, act),
              engb.fused_spmv(xt)),
             (engb.scatter_predicated(xt, act),
              engb.scatter_plain(xt, None, act), engb.scatter(xt)))
    torch.cuda.synchronize()
    for y, yp, full in pairs:
        bit_equal(torch, "pokec bucket K4p", y, yp)
        bit_equal(torch, "pokec bucket K4p vs unpredicated", y, full)
    log("phase 17 pokec planar bucket ANDOR 5%: K5 -> K4p fused and K4p "
        "scatter bit-equal to plain and unpredicated ok")

    # chunked K7p on the SSSP SpMSpV engine (ADDMIN) and the small BFS one
    seng = ch["sssp"].SpMSpV_.engine
    for kind in ("empty", "one", "5pct"):
        xt = frontier_x(torch, seng.num_cols, kind, inf, rng)
        act = seng.tile_activity(xt)
        y, yp, full = (seng.spmv_predicated(xt, act),
                       seng.spmv_predicated_plain(xt, act), seng.spmv(xt))
        torch.cuda.synchronize()
        bit_equal(torch, f"K7p {kind}", y, yp)
        bit_equal(torch, f"K7p {kind} vs unpredicated", y, full)
        ms = time_ms(torch, lambda: seng.spmv_predicated(xt, act))
        kept = seng.active_chunks(act)
        real = int((seng.arrays.vals.view(-1, 1024)[kept] != inf).sum())
        nbytes = chunked_bytes(seng, int(kept.sum()), real, int(act.sum()))
        log(f"phase 17 googleplus chunked ADDMIN {kind}: active tiles "
            f"{int(act.sum())}/{seng.nct}, batches "
            f"{int(seng.kept_batches(act).sum())}/{seng.num_chunks // 32}, "
            f"chunks {int(kept.sum())}, entries {real}; K7p {ms:.4f} ms "
            f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f}); bit-equal to "
            f"plain and to the unpredicated kernel ok")
    r = rec["K7p_chunked_pred"]
    r["ms"], r["err"] = ms, float((y - yp).abs().max())
    r["plain_ms"] = time_ms(torch, lambda: seng.spmv_predicated_plain(
        xt, act), iters=10)
    set_bound(r, nbytes, 2 * real)
    full_ms = time_ms(torch, lambda: seng.spmv(xt))
    log(f"phase 17 googleplus chunked ADDMIN 5%: unpredicated {full_ms:.4f}"
        f" ms, plain K7p {r['plain_ms']:.4f} ms")
    beng = ch["bfs_small"].SpMSpV_.engine
    xt = frontier_x(torch, beng.num_cols, "5pct", 0.0, rng)
    act = beng.tile_activity(xt)
    y, yp, full = (beng.spmv_predicated(xt, act),
                   beng.spmv_predicated_plain(xt, act), beng.spmv(xt))
    torch.cuda.synchronize()
    bit_equal(torch, "K7p ANDOR", y, yp)
    bit_equal(torch, "K7p ANDOR vs unpredicated", y, full)
    log("phase 17 chunked ANDOR 5% (scale 0.1): K7p bit-equal to plain and "
        "unpredicated ok")

    # the push apps' times, with the breakdown's phase split
    apps = (("googleplus bfs", gp["bfs"], "googleplus"),
            ("pokec bfs", pk["bfs"], "pokec"),
            ("googleplus sssp", ch["sssp"], "googleplus"))
    for label, app, graph in apps:
        iters = ICCAD_GRAPHS[graph]["iters"]
        ms = {name: time_ms(torch, lambda: fn(0, iters, device_output=True),
                            iters=5, reps=3)
              for name, fn in (("pull", app.pull), ("push", app.push),
                               ("pull_push", app.pull_push))}
        bd = app.pull_push_time_breakdown(0, iters)
        phases = ", ".join(f"{k} {v:.4f}" for k, v in bd["phases_ms"].items())
        log(f"phase 17 {label}({iters}): pull {ms['pull']:.4f} ms, push "
            f"{ms['push']:.4f} ms, pull_push {ms['pull_push']:.4f} ms; "
            f"breakdown: {bd['push_iterations']} push + "
            f"{bd['pull_iterations']} pull iterations, total "
            f"{bd['total_ms']:.4f} ms, phases ms: {phases}; dispatch floor "
            f"{bd['dispatch_floor_ms']:.4f} ms x {sum(bd['calls'].values())} "
            f"calls; card {card}")


def tropical_bounds(eng) -> dict:
    """(bytes, ops) of the tropical split (K8 or K9) and window reduce
    (K10) on this layout: every entry passes each once. The split reads
    its g1 element and its source byte (K8: the plane entry; K9: the sort
    plane's int32), every descriptor slot's words (rg2, target; K9 also 32
    B of run words) and in_order, and writes the whole window stream g2;
    plane bytes of empty lanes are not counted. K10 reads each entry's g2
    value, sort and row bytes and c_win, writes out, and does one max an
    entry."""
    nel = eng.nnz
    slots = eng.nsteps2 * eng.dstep2
    desc = slots * (12 + (32 if eng.triples else 0)) + 4 * eng.nsteps2 * eng.kb
    split = nel * (8 if eng.triples else 5) + desc + 4 * eng.nchunks2 * 1024
    reduce = 6 * nel + 4 * eng.nchunks2 + 4 * eng.num_windows * 128
    return {"split": (split, 0), "window_reduce": (reduce, nel)}


def tropical_facts(eng) -> str:
    """The layout facts of a tropical engine, for the log."""
    p = eng.planar
    a = eng.arrays
    deposit = (a.xsort2.numel() * 4 + a.tri2.numel() * 4 if eng.triples
               else a.planes2.numel())
    live = int((a.rg2[:, :eng.dstep2, 1] > 0).sum())
    return (f"region_rows={p.region_rows} digits={p.region_rows // 128} "
            f"regions={p.num_regions} pass1 nsteps={p.nsteps} f={p.f} "
            f"g1_MB={p.nsteps * p.f * 4096 / 1e6:.1f} split "
            f"format={'triples' if eng.triples else 'planes'} "
            f"nsteps2={eng.nsteps2} kb={eng.kb} rstep2={eng.rstep2} "
            f"dstep2={eng.dstep2} f2={eng.f2} "
            f"nblocks2={eng.nchunks2 // eng.f2} pieces={live} "
            f"fill2={eng.nnz / (eng.nchunks2 * 1024):.3f} "
            f"split_deposit_MB={deposit / 1e6:.1f} "
            f"g2_MB={eng.nchunks2 * 4096 / 1e6:.1f}")


def decoded_err(a, b) -> float:
    """max |a - b| of two int32 encoding tensors, decoded to float32."""
    from graphlily_tpu_torch.semiring import tropical_decode
    return float((tropical_decode(a) - tropical_decode(b)).abs().max())


def tropical(torch, args, rec: dict, card: str, pk: dict) -> None:
    """Phases 18-20: SSSP on the tropical engine (pokec, planes; googleplus
    at TRIPLES_SCALE, triples), each kernel against its plain version, and
    times."""
    from graphlily_tpu_torch import (EngineConfig, FLOAT_INF,
                                     TropicalSemiring)
    from graphlily_tpu_torch.apps import SSSP
    from graphlily_tpu_torch.io import ICCAD_GRAPHS, iccad_standin
    from graphlily_tpu_torch.module import SpMVModule
    dev = torch.device("cuda")
    inf = float(FLOAT_INF)
    iters = ICCAD_GRAPHS["pokec"]["iters"]

    def load(graph, cfg):
        """An SSSP app formatted for `graph`, its SpMV module's formatting
        (pack + engine init) timed apart from the whole load."""
        app = SSSP(cfg)
        inner, secs = app.SpMV_.load_and_format_matrix, {}

        def timed(*a, **kw):
            t = time.perf_counter()
            inner(*a, **kw)
            secs["pack"] = time.perf_counter() - t
        app.SpMV_.load_and_format_matrix = timed
        t0 = time.perf_counter()
        app.load_and_format_matrix(graph)
        secs["load"] = time.perf_counter() - t0
        eng = app.SpMV_.engine
        if app.SpMV_.engine_name != "tropical":
            raise AssertionError(f"SSSP resolved {app.SpMV_.engine_name!r}, "
                                 "not tropical")
        if app.SpMSpV_.engine is not eng:
            raise AssertionError("SSSP's SpMSpV does not share the tropical "
                                 "engine")
        return app, eng, secs

    # ---- 18. main path: pokec SSSP pull, push and pull_push -----------------
    # the ladder picks the tropical engine at full size (1.63M rows > 700k);
    # a shrunken graph asks for it by name
    engine = "auto" if args.scale >= 1 else "router"
    sssp, eng, secs = load(pk["g"], EngineConfig(sort_rows_by_degree=True,
                                                 engine=engine))
    log(f"phase 18 pokec sssp (scale={args.scale}): engine={engine} -> "
        f"tropical, SpMSpV shares it; relabel+self edges+pack+init "
        f"{secs['load']:.1f} s, of which pack+init {secs['pack']:.1f} s; "
        f"nnz={eng.nnz} {tropical_facts(eng)}")
    reset((eng,))
    runs = {"pull": sssp.pull(0, iters), "push": sssp.push(0, iters),
            "pull_push": sssp.pull_push(0, iters, threshold=0.05)}
    torch.cuda.synchronize()
    launches = dict(eng.launches)
    rec["K4_planar_scatter_addmin"]["launches"] = launches["scatter"]
    rec["K4p_planar_scatter_pred_addmin"]["launches"] = launches[
        "scatter_pred"]
    rec["K8_tropical_split"]["launches"] = launches["split"]
    rec["K10_tropical_window_reduce"]["launches"] = launches["window_reduce"]
    log(f"phase 18 launches: pokec sssp {launches}")
    t0 = time.perf_counter()
    want = sssp.compute_reference_results(0, iters)
    oracle_s = time.perf_counter() - t0
    for label, dist in runs.items():
        check_close(f"pokec sssp {label}", dist, want, exact=True)
    log(f"phase 18 pokec sssp pull(0, {iters}), push(0, {iters}) and "
        f"pull_push(0, {iters}, 0.05): equal to the float64 oracle "
        f"({int((want < inf).sum())} reached, oracle {oracle_s:.1f} s) ok")

    # ---- 19. each kernel against its plain version --------------------------
    rng = np.random.default_rng(19)
    x = rng.integers(0, 1000, eng.num_cols).astype(np.float32)
    x[rng.random(eng.num_cols) < 0.5] = inf    # integers: exact fp32 sums
    xt = torch.from_numpy(x).to(dev)
    g1, g1p = eng.scatter(xt), eng.scatter_plain(xt)
    g2, g2p = eng.split(g1), eng.split_plain(g1)
    out, outp = eng.window_reduce(g2), eng.window_reduce_plain(g2)
    torch.cuda.synchronize()
    bit_equal(torch, "pokec K4 scatter ADDMIN stream", g1, g1p)
    bit_equal(torch, "pokec K8 window stream", g2, g2p)
    bit_equal(torch, "pokec K10 out", out, outp)
    rec["K4_planar_scatter_addmin"]["err"] = decoded_err(g1, g1p)
    rec["K8_tropical_split"]["err"] = decoded_err(g2, g2p)
    rec["K10_tropical_window_reduce"]["err"] = decoded_err(out, outp)
    check_close("pokec tropical engine call", eng(xt).cpu().numpy(),
                sssp.SpMV_.compute_reference_results(x), exact=True)
    log("phase 19 pokec: K4 scatter ADDMIN stream, K8 window stream and K10 "
        "out bit-equal to their plain versions; engine call equal to the "
        "oracle ok")
    times = {}
    for kind in ("empty", "one", "5pct"):
        xf = frontier_x(torch, eng.num_cols, kind, inf, rng)
        act = eng.activity(xf)
        s, sp, full = (eng.scatter_predicated(xf, act),
                       eng.scatter_plain(xf, act), eng.scatter(xf))
        y, yfull = eng.call_predicated(xf), eng(xf)
        torch.cuda.synchronize()
        bit_equal(torch, f"pokec K4p ADDMIN {kind}", s, sp)
        bit_equal(torch, f"pokec K4p ADDMIN {kind} vs unpredicated", s, full)
        bit_equal(torch, f"pokec tropical SpMSpV {kind} vs SpMV", y, yfull)
        ms = time_ms(torch, lambda: eng.scatter_predicated(xf, act))
        call_ms = time_ms(torch, lambda: eng.call_predicated(xf))
        nbytes, nops = router_bounds(eng.planar, act)["scatter"]
        log(f"phase 19 pokec K4p scatter ADDMIN {kind}: active tiles "
            f"{int(act.sum())}/{eng.num_col_tiles}; K4p {ms:.4f} ms (bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f}), SpMSpV call "
            f"{call_ms:.4f} ms; bit-equal to plain and to unpredicated ok")
        times[kind] = (ms, s, sp)
    r = rec["K4p_planar_scatter_pred_addmin"]
    r["ms"], r["err"] = times["5pct"][0], decoded_err(*times["5pct"][1:])
    r["plain_ms"] = time_ms(torch, lambda: eng.scatter_plain(xf, act),
                            iters=10)
    set_bound(r, nbytes, nops)

    # K9 on the googleplus stand-in cut to TRIPLES_SCALE (pass-1 triples
    # too), which keeps the whole run near 750 s since PERM-C joined it
    giters = ICCAD_GRAPHS["googleplus"]["iters"]
    gscale = TRIPLES_SCALE * args.scale
    gsssp, geng, gsecs = load(
        iccad_standin("googleplus", scale=gscale, seed=0),
        EngineConfig(sort_rows_by_degree=True, engine="router",
                     tropical_split_format="triples"))
    if not geng.triples:
        raise AssertionError("the googleplus layout is not in triples format")
    log(f"phase 19 googleplus sssp (scale {gscale:g}), engine=router, split "
        f"format triples: relabel+self edges+pack+init {gsecs['load']:.1f} s,"
        f" of which "
        f"pack+init {gsecs['pack']:.1f} s; nnz={geng.nnz} "
        f"{tropical_facts(geng)}")
    reset((geng,))
    gruns = {"pull": gsssp.pull(0, giters), "push": gsssp.push(0, giters)}
    torch.cuda.synchronize()
    rec["K9_tropical_split_triples"]["launches"] = geng.launches[
        "split_triples"]
    log(f"phase 19 launches: googleplus sssp (triples) {geng.launches}")
    gwant = gsssp.compute_reference_results(0, giters)
    for label, dist in gruns.items():
        check_close(f"googleplus triples sssp {label}", dist, gwant,
                    exact=True)
    # the chunked engine on the same matrix, for phase 20's comparison
    gchunked = SpMVModule(EngineConfig(engine="pallas", device="cuda"))
    gchunked.set_semiring(TropicalSemiring)
    gchunked.load_and_format_matrix(gsssp.SpMV_.csr_matrix_)
    if gchunked.engine.num_cols != geng.num_cols:
        raise AssertionError("the chunked and tropical googleplus layouts "
                             "differ in width")
    x = rng.integers(0, 1000, geng.num_cols).astype(np.float32)
    x[rng.random(geng.num_cols) < 0.5] = inf   # integers: exact fp32 sums
    xg = torch.from_numpy(x).to(dev)
    gwant = gsssp.SpMV_.compute_reference_results(x)
    for label, y in (("tropical", geng(xg)), ("chunked", gchunked.apply(xg))):
        check_close(f"googleplus {label} engine call", y.cpu().numpy(), gwant,
                    exact=True)
    h1 = geng.scatter(xg)
    h2, h2p = geng.split(h1), geng.split_plain(h1)
    hout = geng.window_reduce(h2)
    torch.cuda.synchronize()
    bit_equal(torch, "googleplus K4 scatter ADDMIN (triples)", h1,
              geng.scatter_plain(xg))
    bit_equal(torch, "googleplus K9 window stream", h2, h2p)
    bit_equal(torch, "googleplus K10 out", hout, geng.window_reduce_plain(h2))
    rec["K9_tropical_split_triples"]["err"] = decoded_err(h2, h2p)
    log(f"phase 19 googleplus: sssp pull(0, {giters}) and push(0, {giters}) "
        f"equal to the oracle; the tropical and chunked engine calls equal "
        f"to the oracle; K4 scatter ADDMIN, K9 and K10 bit-equal to their "
        f"plain versions ok")

    # ---- 20. times ------------------------------------------------------------
    bounds = tropical_bounds(eng)
    timed = {
        "K4_planar_scatter_addmin": (lambda: eng.scatter(xt),
                                     lambda: eng.scatter_plain(xt),
                                     router_bounds(eng.planar)["scatter"]),
        "K8_tropical_split": (lambda: eng.split(g1),
                              lambda: eng.split_plain(g1), bounds["split"]),
        "K10_tropical_window_reduce": (lambda: eng.window_reduce(g2),
                                       lambda: eng.window_reduce_plain(g2),
                                       bounds["window_reduce"]),
        "K9_tropical_split_triples": (lambda: geng.split(h1),
                                      lambda: geng.split_plain(h1),
                                      tropical_bounds(geng)["split"]),
    }
    for name, (kernel, plain, (nbytes, nops)) in timed.items():
        r = rec[name]
        r["ms"] = time_ms(torch, kernel)
        r["plain_ms"] = time_ms(torch, plain, iters=10)
        set_bound(r, nbytes, nops)
        log(f"phase 20 {name}: {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
            f"ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)")
    live = int((eng.arrays.rg2[:, :eng.dstep2, 1] > 0).sum())
    log(f"phase 20 K8 reads its planes whole: {live} pieces x 1 KB = "
        f"{live * 1024 / 1e6:.1f} MB of planes, "
        f"{live * 1024 / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s, against "
        f"{eng.nnz / 1e6:.1f} MB for the entries' plane bytes")
    call_ms = time_ms(torch, lambda: eng(xt))
    log(f"phase 20 pokec tropical engine call (K4 scatter -> K8 -> K10 + "
        f"decode): {call_ms:.4f} ms ({gteps(eng.nnz, call_ms)})")
    chunked = gchunked.engine
    t_ms = time_ms(torch, lambda: geng(xg))
    c_ms = time_ms(torch, lambda: chunked(xg))
    log(f"phase 20 googleplus SSSP matrix ({geng.nnz} nnz, "
        f"{geng.num_rows} rows): tropical engine call (triples) {t_ms:.4f} "
        f"ms ({gteps(geng.nnz, t_ms)}) against the chunked engine call "
        f"{c_ms:.4f} ms ({gteps(chunked.nnz, c_ms)})")
    ms = {name: time_ms(torch, lambda: fn(0, iters, device_output=True),
                        iters=5, reps=3)
          for name, fn in (("pull", sssp.pull), ("push", sssp.push),
                           ("pull_push", sssp.pull_push))}
    bd = sssp.pull_push_time_breakdown(0, iters)
    phases = ", ".join(f"{k} {v:.4f}" for k, v in bd["phases_ms"].items())
    log(f"phase 20 pokec sssp({iters}): pull {ms['pull']:.4f} ms, push "
        f"{ms['push']:.4f} ms, pull_push {ms['pull_push']:.4f} ms; "
        f"breakdown: {bd['push_iterations']} push + "
        f"{bd['pull_iterations']} pull iterations, total "
        f"{bd['total_ms']:.4f} ms, phases ms: {phases}; dispatch floor "
        f"{bd['dispatch_floor_ms']:.4f} ms x {sum(bd['calls'].values())} "
        f"calls; card {card}")

def muladd_oracle(csr, x: np.ndarray) -> np.ndarray:
    """Float64 y = A x over the CSR matrix's rows."""
    nnz = csr.nnz
    return np.bincount(csr.row_ids(), minlength=csr.num_rows,
                       weights=csr.adj_data[:nnz].astype(np.float64)
                       * x[csr.adj_indices[:nnz]].astype(np.float64))


def permc_bounds(eng, act=None) -> dict:
    """(bytes, ops) of K11 or K11p and of K4 fused on a PERM-C layout. K11
    reads, per live flushed chunk, its 4 KB of stream, its 3 KB of int8
    destination-lane keys and its code, writes y once, and adds each
    element of the live chunks once; K4 fused is router_bounds' count."""
    t = router_traffic(eng, act)
    return {"reduce": (t["live"] * (7 * 1024 + 4) + t["y"], t["elems"]),
            "fused": router_bounds(eng, act)["fused"]}


def permc(torch, args, rec: dict, card: str, pk: dict) -> None:
    """Phases 21-22: PERM-C (planar_deal="permc") on the pokec stand-in:
    BFS on the full graph, a MULADD engine on BFS's layout, PageRank on
    the quarter graph; each kernel against its plain version, and times."""
    from graphlily_tpu_torch import (EngineConfig, ArithmeticSemiring,
                                     native)
    from graphlily_tpu_torch.apps import PageRank, BFS
    from graphlily_tpu_torch.io import ICCAD_GRAPHS
    from graphlily_tpu_torch.module import spmv_module
    from graphlily_tpu_torch.ops import PlanarSpMV
    dev = torch.device("cuda")
    iters = ICCAD_GRAPHS["pokec"]["iters"]
    engine = "auto" if args.scale >= 1 else "planar"

    # ---- 21. the layout: relabel, C++ greedy + numpy tail, init ------------
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    secs, layouts = {"greedy": 0.0}, []
    pack, greedy = spmv_module.pack_planar, native.permc_greedy

    def timed_pack(*a, **kw):
        t = time.perf_counter()
        layouts.append(pack(*a, **kw))
        secs["pack"] = time.perf_counter() - t
        return layouts[-1]

    def timed_greedy(*a, **kw):
        t = time.perf_counter()
        out = greedy(*a, **kw)
        secs["greedy"] += time.perf_counter() - t
        return out

    spmv_module.pack_planar, native.permc_greedy = timed_pack, timed_greedy
    try:
        t0 = time.perf_counter()
        bfs = BFS(EngineConfig(sort_rows_by_degree=True, engine=engine,
                               planar_deal="permc"))
        bfs.load_and_format_matrix(pk["g"])
        load_s = time.perf_counter() - t0
    finally:
        spmv_module.pack_planar, native.permc_greedy = pack, greedy
    eng = bfs.SpMV_.engine
    if bfs.SpMV_.engine_name != "planar" or not eng.permc or not eng.fused:
        raise AssertionError(f"pokec BFS with planar_deal='permc' resolved "
                             f"{bfs.SpMV_.engine_name!r}, not fused PERM-C")
    if bfs.SpMSpV_.engine is not eng:
        raise AssertionError("the PERM-C BFS holds two copies of its engine")
    a = eng.arrays
    w2 = a.rg[..., 1]
    runs = int((a.c_end > a.c_beg).sum())
    log(f"phase 21 pokec bfs PERM-C layout (scale={args.scale}, "
        f"{pk['g'].nnz} edges, engine={engine}): g++ build {build_s:.2f} s; "
        f"relabel+pack+init {load_s:.1f} s, of which pack {secs['pack']:.1f}"
        f" s (C++ greedy, two passes, {secs['greedy']:.1f} s); "
        f"region_rows={eng.region_rows} regions={eng.num_regions} "
        f"cb={eng.cb} f={eng.f} dstep={eng.dstep} nsteps={eng.nsteps} "
        f"slots={eng.num_slots} pieces={int((w2[:, :eng.dstep] > 0).sum())} "
        f"flushes={int((w2 < 0).sum())} "
        f"stream_MB={eng.nsteps * eng.f * 4096 / 1e6:.1f} row_runs={runs} "
        f"elements_per_run={eng.nnz / max(runs, 1):.3f} fused={eng.fused}")
    t0 = time.perf_counter()
    muladd = PlanarSpMV(layouts[-1], ArithmeticSemiring,
                        EngineConfig(device="cuda"))
    del layouts[:]
    log(f"phase 21 MULADD engine on the same layout: init "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pr = PageRank(EngineConfig(sort_rows_by_degree=True, engine="planar",
                               planar_deal="permc"))
    pr.load_and_format_matrix(pk["gb"], 0.9)
    pr_eng = pr.SpMV_.engine
    if not pr_eng.permc or not pr_eng.fused:
        raise AssertionError("pokec PageRank did not pack a fused PERM-C "
                             "layout")
    log(f"phase 21 pokec pagerank PERM-C layout (scale "
        f"{BUCKET_SCALE * args.scale:g}, {pk['gb'].nnz} edges): "
        f"relabel+pack+init {time.perf_counter() - t0:.1f} s "
        f"regions={pr_eng.num_regions} cb={pr_eng.cb} f={pr_eng.f} "
        f"nsteps={pr_eng.nsteps} slots={pr_eng.num_slots}")

    # ---- 21. main path: BFS and PageRank through the public API ------------
    reset((eng, pr_eng))
    dists = {"pull fused": bfs.pull(0, iters),
             "push fused": bfs.push(0, iters),
             "pull_push fused": bfs.pull_push(0, iters, threshold=0.05)}
    eng.fused = False              # the split branch, through the same API
    dists["pull split"] = bfs.pull(0, iters)
    dists["push split"] = bfs.push(0, iters)
    eng.fused = True
    rank = pr.pull(0.9, 10)
    torch.cuda.synchronize()
    rec["K4_planar_fused_permc"]["launches"] = (eng.launches["fused"]
                                                + pr_eng.launches["fused"])
    rec["K4p_planar_fused_pred_permc"]["launches"] = eng.launches[
        "fused_pred"]
    rec["K11_permc_reduce"]["launches"] = eng.launches["permc_reduce"]
    rec["K11p_permc_reduce_pred"]["launches"] = eng.launches[
        "permc_reduce_pred"]
    rec["K4_planar_scatter"]["launches"] += eng.launches["scatter"]
    rec["K4p_planar_scatter_pred"]["launches"] += eng.launches[
        "scatter_pred"]
    log(f"phase 21 launches: pokec bfs {eng.launches} pagerank "
        f"{pr_eng.launches}")
    want = bfs.compute_reference_results(0, iters)
    for label, dist in dists.items():
        check_close(f"pokec PERM-C bfs {label}", dist, want, exact=True)
    log(f"phase 21 bfs pull(0, {iters}) fused and split, push(0, {iters}) "
        f"fused and split, pull_push(0, {iters}, 0.05) on PERM-C: equal to "
        f"the oracle ({int((want > 0).sum())} reached) ok")
    err = check_close("pokec PERM-C pagerank", rank,
                      pr.compute_reference_results(0.9, 10), exact=False)
    log(f"phase 21 pagerank pull(0.9, 10) on PERM-C (scale "
        f"{BUCKET_SCALE * args.scale:g}): max|r-r64|={err:.3e} ok")

    # ---- 21. each kernel against its plain version --------------------------
    rng = np.random.default_rng(21)
    x = rng.random(muladd.num_cols).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    want = muladd_oracle(bfs.SpMV_.csr_matrix_, x)
    s, sp = muladd.scatter(xt), muladd.scatter_plain(xt)
    y11, y11p = muladd.reduce(s), muladd.reduce_plain(s)
    y4, y4p = muladd.fused_spmv(xt), muladd.fused_plain(xt)
    torch.cuda.synchronize()
    bit_equal(torch, "PERM-C MULADD K4 stream", s, sp)
    for label, y in (("K4 scatter -> K11", y11), ("K11 plain", y11p),
                     ("K4 fused PERM-C", y4), ("K4 fused plain", y4p),
                     ("engine call", muladd(xt))):
        err = check_close(f"PERM-C MULADD {label}", y.cpu().numpy(), want,
                          exact=False)
        log(f"phase 21 MULADD {label}: max|y-y64|={err:.3e} "
            f"max|y64|={np.abs(want).max():.6e} ok")
    rec["K11_permc_reduce"]["err"] = float((y11 - y11p).abs().max())
    rec["K4_planar_fused_permc"]["err"] = float((y4 - y4p).abs().max())
    xa = (rng.random(eng.num_cols) < 0.05).astype(np.float32)
    xat = torch.from_numpy(xa).to(dev)
    sa = eng.scatter(xat)
    pairs = (("K11", eng.reduce(sa), eng.reduce_plain(sa)),
             ("K4 fused PERM-C", eng.fused_spmv(xat), eng.fused_plain(xat)))
    torch.cuda.synchronize()
    want = bfs.SpMV_.compute_reference_results(xa)
    for label, y, yp in pairs:
        bit_equal(torch, f"PERM-C ANDOR {label}", y, yp)
        check_close(f"PERM-C ANDOR {label}", (y != 0).cpu().numpy(), want,
                    exact=True)
    log("phase 21 ANDOR (5% x): K11 and K4 fused PERM-C bit-equal to their "
        "plain versions and, clamped, to the oracle ok")
    times = {}
    for kind in ("empty", "one", "5pct"):
        xf = frontier_x(torch, eng.num_cols, kind, 0.0, rng)
        if kind == "one":          # BFS's first push frontier: a random
            xf.zero_()             # column may lie in the edgeless tail
            xf[bfs._internal_source(0)] = 1.0
        act = eng.activity(xf)
        live = eng.live_chunks(act)
        sf = eng.scatter_predicated(xf, act)
        y11, y11p = eng.reduce_predicated(sf, live), eng.reduce_plain(
            sf, None, live)
        y4, y4p = eng.fused_predicated(xf, act), eng.fused_plain(
            xf, None, act)
        full = eng.fused_spmv(xf)
        torch.cuda.synchronize()
        for label, y, yp in (("K11p", y11, y11p), ("K4p fused", y4, y4p)):
            bit_equal(torch, f"PERM-C {kind} {label}", y, yp)
            bit_equal(torch, f"PERM-C {kind} {label} vs unpredicated", y,
                      full)
        times[kind] = {
            "K11p": time_ms(torch, lambda: eng.reduce_predicated(sf, live)),
            "K4p": time_ms(torch, lambda: eng.fused_predicated(xf, act))}
        bounds = permc_bounds(eng, act)
        log(f"phase 21 ANDOR {kind}: live flush chunks {int(live.sum())}; "
            f"K11p {times[kind]['K11p']:.4f} ms (bound "
            f"{bounds['reduce'][0] / HBM_BYTES_PER_S * 1e3:.6f}), K4p fused "
            f"PERM-C {times[kind]['K4p']:.4f} ms (bound "
            f"{bounds['fused'][0] / HBM_BYTES_PER_S * 1e3:.6f}); bit-equal "
            f"to plain and to the unpredicated kernels ok")
    act_m = muladd.activity(xf)
    live_m = muladd.live_chunks(act_m)
    sm = muladd.scatter_predicated(xf, act_m)
    y11m = muladd.reduce_predicated(sm, live_m)
    y4m = muladd.fused_predicated(xf, act_m)
    torch.cuda.synchronize()
    errs = {"K11p": float((y11m - muladd.reduce_plain(sm, None, live_m))
                          .abs().max()),
            "K4p": float((y4m - muladd.fused_plain(xf, None, act_m))
                         .abs().max())}
    scale = float(y4m.abs().max())
    for label, e in errs.items():
        if e > MULADD_RTOL * scale:
            raise AssertionError(f"PERM-C MULADD 5% {label}: {e} > "
                                 f"{MULADD_RTOL * scale}")
    log(f"phase 21 MULADD 5%: K11p within {errs['K11p']:.3e} and K4p fused "
        f"PERM-C within {errs['K4p']:.3e} of plain (max|y| {scale:.6e}) ok")

    # ---- 22. times ------------------------------------------------------------
    for name, key, (nbytes, nops) in (
            ("K11p_permc_reduce_pred", "K11p", permc_bounds(eng, act)[
                "reduce"]),
            ("K4p_planar_fused_pred_permc", "K4p", permc_bounds(eng, act)[
                "fused"])):
        r = rec[name]
        r["ms"], r["err"] = times["5pct"][key], errs[key]
        set_bound(r, nbytes, nops)
    rec["K11p_permc_reduce_pred"]["plain_ms"] = time_ms(
        torch, lambda: eng.reduce_plain(sf, None, live), iters=10)
    rec["K4p_planar_fused_pred_permc"]["plain_ms"] = time_ms(
        torch, lambda: eng.fused_plain(xf, None, act), iters=10)
    bounds = permc_bounds(muladd)
    timed = {"K11_permc_reduce": (lambda: muladd.reduce(s),
                                  lambda: muladd.reduce_plain(s),
                                  bounds["reduce"]),
             "K4_planar_fused_permc": (lambda: muladd.fused_spmv(xt),
                                       lambda: muladd.fused_plain(xt),
                                       bounds["fused"])}
    for name, (kernel, plain, (nbytes, nops)) in timed.items():
        r = rec[name]
        r["ms"] = time_ms(torch, kernel)
        r["plain_ms"] = time_ms(torch, plain, iters=10)
        set_bound(r, nbytes, nops)
        log(f"phase 22 {name}: {r['ms']:.4f} ms ({gteps(muladd.nnz, r['ms'])})"
            f" plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / 1e6:.1f} MB)")
    rec["K4_planar_fused_permc"]["library_ms"] = library_mv(
        torch, bfs.SpMV_.csr_matrix_, xt, muladd_oracle(
            bfs.SpMV_.csr_matrix_, x))
    fused_ms = time_ms(torch, lambda: muladd(xt))
    muladd.fused = False
    split_ms = time_ms(torch, lambda: muladd(xt))
    muladd.fused = True
    free = pk["pr"].SpMV_.engine
    free_ms = time_ms(torch, lambda: free(pk["x"]))
    free_k4_ms = time_ms(torch, lambda: free.fused_spmv(pk["x"]))
    log(f"phase 22 pokec MULADD engine call: PERM-C fused {fused_ms:.4f} ms "
        f"({gteps(muladd.nnz, fused_ms)}), PERM-C split K4 scatter -> K11 "
        f"{split_ms:.4f} ms ({gteps(muladd.nnz, split_ms)}); free deal fused "
        f"(phase 10's engine) {free_ms:.4f} ms ({gteps(free.nnz, free_ms)}), "
        f"its K4 fused {free_k4_ms:.4f} ms; library torch.mv "
        f"{rec['K4_planar_fused_permc']['library_ms']:.4f} ms; device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.1f} GB, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.1f} GB")
    ms = {name: time_ms(torch, lambda: fn(0, iters, device_output=True),
                        iters=5, reps=3)
          for name, fn in (("pull", bfs.pull), ("push", bfs.push),
                           ("pull_push", bfs.pull_push))}
    pr_ms = time_ms(torch, lambda: pr.pull(0.9, 100, device_output=True),
                    iters=1, reps=3) / 100
    log(f"phase 22 pokec bfs({iters}) on PERM-C: pull {ms['pull']:.4f} ms, "
        f"push {ms['push']:.4f} ms, pull_push {ms['pull_push']:.4f} ms; "
        f"pagerank (scale {BUCKET_SCALE * args.scale:g}) {pr_ms:.4f} "
        f"ms/iter; card {card}")


if __name__ == "__main__":
    sys.exit(main())
