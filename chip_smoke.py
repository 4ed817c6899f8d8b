#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphlily_tpu_torch) on one GPU.

Drives the port's main paths once, through the entry points a user
calls, and checks every result against the float64 oracles:

  * the googleplus stand-in (RMAT, 107,614 vertices, 13,673,453 edges,
    seed 0, degree-sorted) through the roll router (K1, K2, K3);
  * the pokec stand-in (RMAT, 1,632,803 vertices, 30,622,564 edges,
    seed 0, degree-sorted) through the planar router (K4 fused, which
    is K1's kernel over the engine's row-sorted element form, and K4
    scatter, a store walk over its piece-ordered store form, -> K3), also
    under planar_deal="bucket" on a quarter of it, whose forms resolve x2
    slots to x columns at init: K5 (xperm) is held to its plain version
    but no app path launches it;
  * SSSP on the googleplus stand-in (self edges added: 13,780,368 nnz),
    through the chunked engine (the K6/K7 kernel), and PageRank and BFS
    on the googleplus stand-in at scale 0.1, which the ladder also sends
    to the chunked engine;
  * push and pull_push (SpMSpV) of BFS on both stand-ins and of SSSP on
    googleplus, through the frontier-predicated kernels: K1p, K2p -> K3p
    (roll), K4p fused (K1p's kernel over the planar tile form) and K4p
    scatter -> K3p (planar), K7p (chunked);
  * SSSP pull, push and pull_push on the pokec stand-in (self edges
    added: 32,254,873 nnz), which the ladder sends to the tropical engine
    (its walk: K4 fused and K4p fused in ADDMIN mode, K1's kernel over
    the pass-1 row and tile forms, folding K10's max into the walk), and
    SSSP on half of the googleplus stand-in through the tropical engine
    by name; the TPU's three-pass stages (`TropicalStages`: K4 scatter
    and K4p scatter in ADDMIN mode, K8 or K9 split, K10 window reduce),
    which no app path builds, are built beside each ("planes" on pokec,
    "triples" on googleplus) and held to their plain versions and to the
    walk;
  * BFS pull, push and pull_push on the full pokec stand-in and PageRank
    on a quarter of it with planar_deal="permc" (PERM-C layouts, packed
    by the C++ greedy): K4 fused over the same form, K4p fused on PERM-C
    rows, K4 scatter -> K11 (K3's kernel over the position-keyed rows)
    and K4p scatter -> K11p.

Phases, one or more lines each:

  1. card      nvidia-smi name and power limit; TF32 switched off
  2. build     nvcc build of csrc/*.cu, one nvcc per source, in parallel
  3. kernels   googleplus: K1, K2, K3 and their plain PyTorch versions on
               the router layout, MULADD and ANDOR, each held against
               SpMVModule.compute_reference_results; K2's flush stream
               must equal its plain version bit for bit, and ANDOR K1
               both its plain walk of the derived form and K2 -> K3's,
               ANDOR K3 its plain version; the form's init seconds,
               elements and MB; K3's region-group table (groups, sole
               groups, chunks, MB, seconds to derive)
  4. pagerank  googleplus PageRank.pull(0.9, 10): engine roll, fused
  5. bfs       googleplus BFS.pull(0, 7), fused and split (K2 -> K3)
  6. times     googleplus, CUDA events, min over 5 reps of a 100-call
               loop: kernels and plain versions (ms, GTEPS), PageRank
               ms/iter, BFS pull ms; then, counted on the host from the
               table and the tiles' occupancy, the global reductions K3
               issues (vector reductions and sole groups' quad stores)
               against the float atomics of the per-chunk kernel it
               replaced (one per warp run of a row with a nonzero sum);
               K3's library time: index_add_ of the flushed slots
               (gathered) into a zeroed y through a row map built
               beforehand from the table
  7. pokec     the graph, then PageRank and BFS formatted through
               EngineConfig(sort_rows_by_degree=True) (engine "auto" ->
               planar, deal "free"), layout facts and pack seconds, the
               derived forms (init seconds; K4 fused's row form, K4p
               fused's tile form and K4 scatter's store form: elements,
               segments, blocks, the largest block's segments, MB, the y
               atomics the row forms issue at most);
               a third BFS packs the "bucket" deal on the stand-in at
               scale 0.25 (BUCKET_SCALE)
  8. apps      pokec PageRank.pull(0.9, 10) and BFS.pull(0, 11) fused and
               split, and BFS.pull(0, 11) on the bucket layout fused and
               split (K4 scatter -> K3, no K5); K5's launches (0)
  9. kernels   pokec, on the apps' engines: K4 fused and K4 scatter -> K3
               against their plain versions and the oracle, MULADD
               (PageRank's engine) and ANDOR (BFS's); K4's flush stream
               bit-equal to its plain version through the layout and to
               its store form's walk; K5's x2 bit-equal to its plain
               version; bucket K4 scatter (no K5) bit-equal to K5 -> K4
               scatter's plain versions, bucket ANDOR K4 fused to its
               plain versions, bucket ANDOR K3 on that stream to its
               plain version and, clamped, to the oracle; ANDOR K3 on
               the free stream bit-equal to its plain version
  10. times    pokec, as phase 6 (K3 on the free deal's MULADD stream, its
               table, its global reductions and its library index_add_),
               plus the planar engine
               call fused and split
  11. sssp     googleplus SSSP(EngineConfig(sort_rows_by_degree=True)):
               engine "auto" -> chunked; layout facts and load seconds,
               the padding-free device form (init seconds, entries,
               segments, blocks, bytes against the padded streams');
               pull(0, 7) bit-equal to the oracle
  12. chunked  the K6/K7 kernel against its plain version and the oracle:
               ADDMIN on the SSSP layout, MULADD and ANDOR on googleplus
               through engine="pallas"; PageRank.pull(0.9, 10) and
               BFS.pull(0, 7) on googleplus at scale 0.1 (engine "auto" ->
               chunked)
  13. times    the chunked kernel and its plain version (ADDMIN, MULADD,
               ANDOR; the MULADD instance has its own kernels-JSON record
               beside torch.mv on the same graph), SSSP pull(0, 7) ms, the
               chunked MULADD engine call against the roll router's fused
               call on the same graph
  14. push     googleplus BFS (the phase 4-5 app; SpMSpV shares its roll
               engine): push(0, 7) and pull_push(0, 7, threshold=0.05),
               fused (K1p) and split (K2p -> K3p), bit-equal to the oracle
  15. push     pokec BFS push(0, 11) and pull_push(0, 11) on the free deal,
               fused (K4p fused) and split (K4p scatter -> K3p), and push
               on the bucket deal (K4p fused, no K5); K5's launches (0).
               In phases 4-5, 8, 12, 14, 15 and 21 every launch of BFS's
               level step (bfs_step) is held bit for bit against its
               plain version on that launch's own y and distance, one an
               iteration; here its time on the largest launch's inputs
               and on 524,288 vertices (s19's), wrapper calls and device
               time, beside the plain version's and the bound
  16. push     googleplus SSSP (the phase 11 app; SpMSpV packs its own
               chunk_order="col" layout) push(0, 7) and pull_push(0, 7)
               (K7p, ADDMIN) and BFS push on googleplus at scale 0.1 (K7p,
               ANDOR); the col layout's chunks and the batches a 1-vertex
               frontier keeps; every launch of SSSP's relax kernel
               (sssp_relax) held bit for bit against its plain version on
               that launch's own y and distance, one a push step, and its
               time on the last push step's y and distance (wrapper calls
               and device time) beside the plain version's and the bound
  17. kernels  each predicated kernel against its plain version and the
               unpredicated kernel for three frontiers (empty, 1 vertex,
               5% of the columns), and their times (CUDA events, min over
               5 reps of 100 calls); push and pull_push ms of each app with
               the push steps, pull steps and host reads of a profiled
               pull_push (its apps.* spans)
  18. sssp     pokec SSSP(EngineConfig(sort_rows_by_degree=True)): engine
               "auto" -> tropical, SpMSpV sharing it; load and pass-1 pack
               seconds, the walk's forms (row and tile: init s, MB);
               pull(0, 11), push(0, 11) and pull_push(0, 11, 0.05)
               bit-equal to the oracle; their launches: the walk (fused,
               fused_pred), the engine's only counters; SSSP's relax
               kernel held to its plain version as in phase 16
  19. kernels  pokec: the three passes built on the pass 1 the app's
               walk reads (layout facts, schedule pack seconds, the store
               form and K8's compact form: init s, MB); the app's walk
               bit-equal to its plain version and to the three kernels'
               out; K4 scatter ADDMIN's stream, K8's window stream and
               K10's maxima bit-equal to their plain versions; the
               predicated walk and K4p scatter ADDMIN against their plain
               versions, the unpredicated walk and scatter and the
               three-pass out at empty, 1-vertex and 5% frontiers;
               googleplus SSSP at scale 0.5 (TRIPLES_SCALE: cut from the
               full graph to keep the whole run near 750 s) with
               engine="router": pull(0, 7) and push(0, 7) against the
               oracle; its three passes' schedule packed with
               split_format="triples": K9 bit-equal to its plain version,
               the walk bit-equal to the three kernels' out, the tropical
               and a chunked engine call on its matrix against the
               oracle; the SSSP runs launch the walk only
  20. times    the walk (and at three frontiers, predicated), the
               three-pass kernels and their plain versions, bounds, the
               pokec tropical engine call against the three passes, the
               googleplus tropical (triples)
               engine call against the chunked engine call on the same
               matrix, pokec SSSP pull, push and pull_push ms and the
               step and read spans of a profiled pull_push
  21. permc    pokec BFS(EngineConfig(sort_rows_by_degree=True,
               planar_deal="permc")) on the full graph (engine "auto" ->
               planar; SpMSpV shares it): g++ build, C++ greedy, pack and
               load seconds, layout facts (row runs, elements a run),
               the derived forms as in phase 7;
               pull(0, 11) fused and split, push(0, 11) fused and split,
               pull_push(0, 11, 0.05) bit-equal to the oracle; PageRank
               pull(0.9, 10) on PERM-C on the quarter graph of phase 7; a
               MULADD engine on BFS's layout: K4 fused PERM-C and K4
               scatter -> K11 against their plain versions and the
               float64 oracle; ANDOR K11 and K4 fused bit-equal to plain;
               K11's region-group table; K11p and K4p fused PERM-C at
               empty, 1-vertex and 5% frontiers bit-equal to plain and
               unpredicated, MULADD at 5%
  22. times    K11, K11p, K4 fused and K4p fused PERM-C against their plain
               versions and bounds; K11's global reductions against the
               per-chunk kernel's atomics (one per chunk, lane and row
               with a nonzero sum); K11's library index_add_, as phase
               6's; torch.mv on BFS's matrix; the PERM-C
               engine call fused and split against the free deal's fused
               call (phase 10's engine); BFS pull, push and pull_push ms,
               PageRank ms/iter

The launch counters are set to 0 right before each path's app runs
(phases 4-5, 8, 11, 12, 14-16, 18, 19's googleplus SSSP and 21) and read
right after; every kernel of the path must have run there (K5, which no
app path runs since K4 scatter and K4p fused read x columns resolved at
init, keeps its row with 0 launches). The three-pass stages K4 scatter
ADDMIN, K4p scatter ADDMIN, K8, K9 and K10 (STAGES) have no launches to
count: no app engine owns them (the tropical engine is its walk), so
their rows print launches null. Then it prints the kernels' JSON line:
per kernel its launches on the app paths, its largest difference from its
plain version, its time, its plain version's, its bound (the larger of
the bytes it must move over 3.35 TB/s and its fp32 operations over
67 TFLOP/s, the H100 SXM's published peaks, counted from this run's
inputs; K1's and K4 fused's from the SpMV function itself, 8 B an entry
plus row words, x and y, the same for every deal (`mv_bound`); a
predicated kernel's from its 5% frontier; the tropical
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
import importlib.util
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the SpMV function's bound, from the benchmark's bounds.py (which imports
# nothing), loaded by path: bench_torch/ does not join sys.path
_spec = importlib.util.spec_from_file_location(
    "bench_torch_bounds", ROOT / "bench_torch" / "bounds.py")
_bounds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bounds)
mv_bound = _bounds.mv_bound
ROUTER_SRC = "graphlily_tpu_torch/csrc/router_spmv.cu"
PLANAR_SRC = "graphlily_tpu_torch/csrc/planar_spmv.cu"
CHUNKED_SRC = "graphlily_tpu_torch/csrc/chunked_spmv.cu"
TROPICAL_SRC = "graphlily_tpu_torch/csrc/tropical_spmv.cu"
PERMC_SRC = "graphlily_tpu_torch/csrc/permc_spmv.cu"
SSSP_SRC = "graphlily_tpu_torch/csrc/sssp_relax.cu"
BFS_SRC = "graphlily_tpu_torch/csrc/bfs_step.cu"
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "K1_router_fused": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:419"),
    "K2_router_scatter": (ROUTER_SRC,
                          "graphlily_tpu/ops/router_pallas.py:368"),
    "K3_router_reduce": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:756"),
    # K4 fused runs K1's kernel over the planar engine's row-sorted form
    "K4_planar_fused": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4_planar_scatter": (PLANAR_SRC,
                          "graphlily_tpu/ops/router_pallas.py:1398"),
    "K5_planar_xperm": (PLANAR_SRC, "graphlily_tpu/ops/router_pallas.py:924"),
    # one kernel for both chunked launchers: K7 (resident) and K6 (streamed)
    "K6_K7_chunked": (CHUNKED_SRC,
                      "graphlily_tpu/ops/spmv_pallas.py:294 (K7), "
                      "graphlily_tpu/ops/spmv_pallas.py:160 (K6)"),
    # the same kernel's MULADD instance, beside cuSPARSE on the same graph
    "K6_K7_chunked_muladd": (CHUNKED_SRC,
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
    # K4p fused runs K1p's kernel over the planar engine's tile form
    "K4p_planar_fused_pred": (ROUTER_SRC,
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
    # the tropical engine's walk: K1's kernel in ADDMIN mode over the
    # pass-1 row form (K4 fused's ADDMIN instance) and tile form (K4p
    # fused's), with K10's int32 max folded in
    "K4_planar_fused_addmin": (ROUTER_SRC,
                               "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4p_planar_fused_pred_addmin": (
        ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:1459"),
    # PERM-C: the split branch's run-sum reduce and its predicated launch
    # (sm/na), and K4 fused's PERM-C instance (permc=True, with beg)
    # K11 runs K3's kernel over the PERM-C layout's position-keyed rows
    "K11_permc_reduce": (ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:851"),
    "K11p_permc_reduce_pred": (PERMC_SRC,
                               "graphlily_tpu/ops/router_pallas.py:851"),
    "K4_planar_fused_permc": (ROUTER_SRC,
                              "graphlily_tpu/ops/router_pallas.py:1459"),
    "K4p_planar_fused_pred_permc": (
        ROUTER_SRC, "graphlily_tpu/ops/router_pallas.py:1459"),
    # SSSP's push-step relax: no Pallas kernel; the JAX app's relax is jnp
    # glue that XLA fuses
    "sssp_relax": (SSSP_SRC, "none (graphlily_tpu/apps/sssp.py:112-115, "
                   "jnp glue)"),
    # BFS's level step: no Pallas kernel; the JAX app's clamp, mask and
    # stamp are the SpMV's epilogue and jnp glue that XLA fuses
    "bfs_step": (BFS_SRC, "none (graphlily_tpu/apps/bfs.py:112-134, "
                 "jnp glue)"),
}
BUCKET_SCALE = 0.25  # the pokec stand-in's cut for the "bucket" deal
# the TPU's three-pass stages, held to their plain versions and the walk;
# no app engine owns them (the tropical engine's SpMV and SpMSpV are its
# walk), so their launches are not counted: null in the kernels line
STAGES = {"K4_planar_scatter_addmin", "K4p_planar_scatter_pred_addmin",
          "K8_tropical_split", "K9_tropical_split_triples",
          "K10_tropical_window_reduce"}
# K5 is held to its plain version and counted on the app paths, where no
# path launches it: the planar forms resolve x2 at engine init
OFF_PATH = {"K5_planar_xperm"}
TRIPLES_SCALE = 0.5  # the googleplus stand-in's cut for the "triples" SSSP
MULADD_RTOL = 1e-4   # fp32 atomics in any order over hub rows of ~1e5 terms
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks at 700 W
FP32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


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


def step_spans(torch, fn) -> str:
    """The push-step, pull-step and host-read spans of one profiled call
    of `fn` (the app's own `apps.*` spans)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    n = {k.key: k.count for k in prof.key_averages()}
    return (f"{n.get('apps.push_step', 0)} push + "
            f"{n.get('apps.pull_step', 0)} pull steps, "
            f"{n.get('apps.host_read', 0)} host reads")


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


class SSSPKernelCheck:
    """While open, every call of `ops.sssp_relax.relax` by the apps is
    held bit for bit against `relax_plain` on that call's own y and
    distance, cloned before the in-place launch: distance, frontier and
    count. Counts the calls and keeps the last call's inputs."""

    def __init__(self, torch):
        from graphlily_tpu_torch.ops import sssp_relax
        self.torch, self.mod = torch, sssp_relax
        self.calls, self.last = 0, None

    def _relax(self, y, distance, count, launches):
        m, torch = self.mod, self.torch
        y0, d0, c0 = y.clone(), distance.clone(), int(count)
        out = self.real(y, distance, count, launches)
        want_d, want_f, want_c = m.relax_plain(y0, d0)
        bit_equal(torch, "sssp_relax distance", distance, want_d)
        bit_equal(torch, "sssp_relax frontier", y, want_f)
        if int(count) - c0 != int(want_c):
            raise AssertionError(f"sssp_relax counted {int(count) - c0}, "
                                 f"plain {int(want_c)}")
        self.calls += 1
        self.last = (y0, d0)
        return out

    def __enter__(self):
        self.real, self.mod.relax = self.mod.relax, self._relax
        return self

    def __exit__(self, *exc):
        self.mod.relax = self.real


class BFSStepCheck:
    """While open, every call of `ops.bfs_step.step` by the apps is held
    bit for bit against `step_plain` on that call's own y and distance,
    cloned before the in-place launch: frontier, distance and count. The
    apps' `launches["step"]` are zeroed on entry and, on a clean exit,
    must read the calls made; they add to `rec["bfs_step"]["launches"]`.
    Keeps the largest call's inputs for the times."""

    def __init__(self, torch, rec: dict, *apps):
        from graphlily_tpu_torch.ops import bfs_step
        self.torch, self.mod, self.rec, self.apps = torch, bfs_step, rec, apps
        self.calls, self.last = 0, None

    def _step(self, y, distance, count, level, launches):
        m, torch = self.mod, self.torch
        y0, d0, c0 = y.clone(), distance.clone(), int(count)
        out = self.real(y, distance, count, level, launches)
        want_f, want_d, want_c = m.step_plain(y0, d0, level)
        bit_equal(torch, "bfs_step frontier", y, want_f)
        bit_equal(torch, "bfs_step distance", distance, want_d)
        if int(count) - c0 != int(want_c):
            raise AssertionError(f"bfs_step counted {int(count) - c0}, "
                                 f"plain {int(want_c)}")
        self.calls += 1
        if self.last is None or d0.numel() >= self.last[1].numel():
            self.last = (y0, d0, level)
        return out

    def __enter__(self):
        for app in self.apps:
            app.launches["step"] = 0
        self.real, self.mod.step = self.mod.step, self._step
        return self

    def __exit__(self, exc, *rest):
        self.mod.step = self.real
        if exc is None:
            self.torch.cuda.synchronize()
            launched = sum(app.launches["step"] for app in self.apps)
            if launched != self.calls or not self.calls:
                raise AssertionError(f"bfs launched {launched} steps, step "
                                     f"calls {self.calls}")
            r = self.rec["bfs_step"]
            r["launches"] = r.get("launches", 0) + launched


def bfs_step_times(torch, chk: BFSStepCheck, rec: dict, card: str) -> None:
    """Phase 15's time of BFS's level step on the largest app call's y
    and distance (repeated calls move the same bytes) and on a random
    case at s19's 524,288 vertices, held to its plain version first;
    beside the plain version and the bound, 16 B an entry."""
    from graphlily_tpu_torch.ops import _build
    m = chk.mod
    launches = _build.Launches("bfs", ("step",))
    slot = torch.zeros(1, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(19)
    n19 = 1 << 19
    y19 = (torch.rand(n19, device="cuda", generator=g) < 0.3).float() * 3
    d19 = torch.where(torch.rand(n19, device="cuda", generator=g) < 0.6,
                      0.0, 4.0)
    want = m.step_plain(y19, d19, 5.0)
    got = m.step(y19.clone(), d19.clone(), slot[0], 5.0, launches)
    bit_equal(torch, "bfs_step frontier (s19 n)", got[0], want[0])
    bit_equal(torch, "bfs_step distance (s19 n)", got[1], want[1])
    if int(slot[0]) != int(want[2]):
        raise AssertionError(f"bfs_step counted {int(slot[0])} at s19's n, "
                             f"plain {int(want[2])}")
    r = rec["bfs_step"]
    r["err"] = 0.0   # bit-equal on every launch (BFSStepCheck)
    for label, (y0, d0, level) in (("app", chk.last),
                                   ("s19", (y19, d19, 5.0))):
        n = d0.numel()
        y, d = y0.clone(), d0.clone()
        ms = time_ms(torch, lambda: m.step(y, d, slot[0], level, launches))
        plain_ms = time_ms(torch, lambda: m.step_plain(y0, d0, level))
        us = device_us(torch, lambda: m.step(y, d, slot[0], level, launches),
                       "bfs_step_kernel")
        bound = {}
        set_bound(bound, 16 * n, n)
        if label == "app":
            r.update(bound, ms=ms, plain_ms=plain_ms)
        log(f"phase 15 bfs_step ({label}, n={n}): {ms:.4f} ms a wrapper "
            f"call, device {us:.2f} us a launch; plain {plain_ms:.4f} ms; "
            f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}, "
            f"{16 * n / 1e6:.2f} MB); card {card}")


def device_us(torch, fn, name: str, iters: int = 100) -> float:
    """Mean device µs of the kernels whose name holds `name`, over
    `iters` profiled calls of `fn`."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if len(times) != iters:
        raise AssertionError(f"{name}: {len(times)} device events for "
                             f"{iters} calls")
    return sum(times) / iters


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


def form_facts(label: str, e) -> str:
    """One element form (ops/router.RouterEntries) for the log, with, for
    a row-ordered form, the y atomics K1's kernel issues on it at most on
    a full x: one per run of one row inside a warp pass's 256 elements."""
    import torch
    from graphlily_tpu_torch.ops.router import entries_index
    row = entries_index(e)[1]
    pos = torch.arange(row.numel(), device=row.device)
    head = (row[1:] != row[:-1]) | (pos[1:] % 256 == 0)
    atomics = ("" if e.order == "stream" else
               f", y atomics at most {int(head.sum()) + 1}")
    return (f"{label} {e.order} order: {e.idx.numel()} elements, "
            f"{e.deps.shape[0]} segments, {e.blocks.shape[0]} blocks "
            f"(at most {e.max_segments} segments), col_bits {e.col_bits}, "
            f"{e.nbytes() / 1e6:.1f} MB{atomics}")


def router_forms(eng) -> str:
    """The roll engine's derived forms for the log: K1's (row order) and
    K1p's (deposit order)."""
    return "; ".join([f"derived forms: init {eng.init_seconds:.2f} s",
                      form_facts("K1", eng.entries),
                      form_facts("K1p", eng.pred_entries)])


def router_bounds(eng, act=None) -> dict:
    """(bytes, ops) of the fused, scatter and reduce kernels."""
    t = router_traffic(eng, act)
    return {
        "fused": (t["a"] + t["desc"] + 2 * t["elems"] + t["x"] + t["y"],
                  2 * t["elems"]),
        "scatter": (t["a"] + t["desc"] + t["x"] + t["stream"], t["elems"]),
        "reduce": (t["live"] * 1024 * 6 + t["y"], t["elems"]),
    }


def group_facts(eng) -> str:
    """Phase C's region-group table (ops/router.reduce_groups) for the
    log: groups, sole groups, flushed chunks, MB and the seconds to derive
    it again on the card."""
    import torch
    from graphlily_tpu_torch.ops.router import reduce_groups
    t0 = time.perf_counter()
    reduce_groups(eng.arrays.c_code)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g = eng.groups.groups
    return (f"region-group table: {g.shape[0]} groups ({int(g[:, 3].sum())}"
            f" sole) of at most {int(g[:, 1].max()) if g.numel() else 0} of "
            f"{eng.groups.order.numel()} flushed chunks, "
            f"{eng.groups.nbytes() / 1e6:.3f} MB, derived in {secs:.4f} s; "
            f"region_rows {eng.region_rows}, {eng.num_regions} regions")


def reduce_reductions(torch, eng, stream) -> str:
    """The global reductions phase C issues on `stream`, counted on the
    host from the engine's region-group table and its tiles' occupancy
    (rows c_hi*128 + c_lo, position-keyed on PERM-C): K3 and K11 (K3's
    kernel) reach y once per quad of rows a group's tile holds nonzero,
    by a vector reduction or, in a region's only group, a store (at most:
    a quad whose terms cancel is skipped too); the per-chunk kernels they
    replaced issued one float atomic per warp run of a row with a nonzero
    sum (K3) or per chunk, lane and row with a nonzero run sum (K11)."""
    g = eng.groups.groups.long()
    order = eng.groups.order.long()
    rr, dev = eng.region_rows, order.device
    slots = torch.arange(1024, device=dev)
    pos = (order[:, None] * 1024 + slots).reshape(-1)
    rows = eng.arrays.c_hi[pos].long() * 128 + eng.arrays.c_lo[pos].long()
    vals = stream.reshape(-1)[pos]
    gid = torch.repeat_interleave(torch.arange(g.shape[0], device=dev),
                                  g[:, 1] * 1024, output_size=pos.numel())
    keep = vals != 0
    quads = torch.unique(gid[keep] * (rr // 4) + rows[keep] // 4)
    sole = g[quads // (rr // 4), 3] == 1
    if getattr(eng, "permc", False):
        chunk = pos // 1024
        key = torch.unique(chunk[keep] * rr + rows[keep])
        old, what = key.numel(), "per (chunk, lane, row) run sum"
    else:
        head = torch.ones_like(keep)
        head[1:] = (rows[1:] != rows[:-1]) | (pos[1:] % 32 == 0)
        run = torch.cumsum(head.long(), 0) - 1
        sums = torch.zeros(int(run[-1]) + 1 if run.numel() else 0,
                           device=dev).index_add_(0, run, vals)
        old, what = int((sums != 0).sum()), "per warp run"
    return (f"global reductions: {int((~sole).sum())} vector reductions + "
            f"{int(sole.sum())} quad stores against the per-chunk kernel's "
            f"{old} float atomics ({what}) on {int(keep.sum())} nonzero "
            f"slots")


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


def library_reduce(torch, eng, stream) -> tuple:
    """ms of PyTorch's own phase C on `stream`: the flushed slots gathered
    (`index_select`) and `index_add_`ed into a zeroed y at their rows,
    through an int64 slot map and row map built beforehand from the
    engine's region-group table, as K3 and K11 read it (rows c_hi*128 +
    c_lo, position-keyed on PERM-C). Checked against the plain version
    first. Returns (the whole call, the index_add_ alone on slots
    gathered beforehand)."""
    order = eng.groups.order.long()
    dev = order.device
    pos = (order[:, None] * 1024
           + torch.arange(1024, device=dev)).reshape(-1)
    at = (eng.arrays.c_code.long()[order].repeat_interleave(1024)
          * eng.region_rows + eng.arrays.c_hi[pos].long() * 128
          + eng.arrays.c_lo[pos].long())
    flat = stream.reshape(-1)
    n = eng.out_len

    def call():
        return torch.zeros(n, device=dev).index_add_(
            0, at, flat.index_select(0, pos))

    check_close("library index_add_ reduce", call().cpu().numpy(),
                eng.reduce_plain(stream).cpu().numpy().astype(np.float64),
                exact=False)
    src = flat.index_select(0, pos)
    return (time_ms(torch, call),
            time_ms(torch, lambda: torch.zeros(n, device=dev).index_add_(
                0, at, src)))


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
    push_paths(torch, args, gp, pk, ch, rec, card)
    predicated_kernels(torch, rec, card, gp, pk, ch)
    tropical(torch, args, rec, card, pk)
    permc(torch, args, rec, card, pk)

    for name, r in rec.items():
        if name in STAGES:
            r["launches"] = None    # no app engine owns them: not counted
        elif r.get("launches", 0) == 0 and name not in OFF_PATH:
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
        y1e = eng.fused_entries_plain(xt)
        s2 = eng.scatter(xt)
        s2p = eng.scatter_plain(xt)
        y3 = eng.reduce(s2)
        y3p = eng.reduce_plain(s2)
        torch.cuda.synchronize()
        bit_equal(torch, f"{semiring.name}: K2 stream", s2, s2p)
        if exact:
            bit_equal(torch, f"{semiring.name}: K1", y1, y1e)
            bit_equal(torch, f"{semiring.name}: K1 vs K2->K3 plain", y1, y1p)
            bit_equal(torch, f"{semiring.name}: K3", y3, y3p)
        for label, y in (("K1", y1), ("K1 plain (form)", y1e),
                         ("K2->K3 plain", y1p), ("K3 (K2->K3)", y3),
                         ("K3 plain", y3p), ("engine call", mod.apply(xt))):
            y = y.cpu().numpy()
            if exact:
                y = (y != 0).astype(np.float64)
            err = check_close(f"{semiring.name} {label}", y, want, exact)
            log(f"phase 3 {semiring.name} {label}: max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        if not exact:
            rec["K1_router_fused"]["err"] = float((y1 - y1e).abs().max())
            rec["K2_router_scatter"]["err"] = float((s2 - s2p).abs().max())
            rec["K3_router_reduce"]["err"] = float((y3 - y3p).abs().max())
            spmv_eng, spmv_x, spmv_mod = eng, xt, mod
        log(f"phase 3 {semiring.name}: K2 stream bit-equal to plain"
            f"{'; K1 bit-equal to both plain versions, K3 to its' if exact else ''}; "
            f"{router_forms(eng)}; K3 {group_facts(eng)}; ok")

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
    with BFSStepCheck(torch, rec, bfs):
        dist_fused = bfs.pull(0, iters)
        bfs_eng.fused = False      # the split branch, through the same API
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
                            lambda: eng.fused_entries_plain(xt)),
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
    nbytes, nops = router_bounds(eng)["reduce"]
    set_bound(rec["K3_router_reduce"], nbytes + eng.groups.nbytes(), nops)
    set_bound(rec["K1_router_fused"],
              *mv_bound(gs.num_rows, gs.num_cols, gs.nnz))
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
    log(f"phase 6 K3 on the googleplus MULADD stream: "
        f"{reduce_reductions(torch, eng, stream)}")
    lib_ms, add_ms = library_reduce(torch, eng, stream)
    rec["K3_router_reduce"]["library_ms"] = lib_ms
    log(f"phase 6 library index_add_ (gather + index_add_ into a zeroed y) "
        f"on the same K3 stream: {lib_ms:.4f} ms, index_add_ alone "
        f"{add_ms:.4f} ms; K3 {rec['K3_router_reduce']['ms']:.4f} ms")
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
        log(f"phase 7 pokec {key} {planar_form(eng)}")
        apps[key] = app
    pr, bfs, bfsb = apps["pagerank"], apps["bfs"], apps["bfs_bucket"]
    pr_eng, bfs_eng = pr.SpMV_.engine, bfs.SpMV_.engine
    bfsb_eng = bfsb.SpMV_.engine

    # ---- 8. main path: PageRank and BFS through the public API ------------
    reset((pr_eng, bfs_eng, bfsb_eng))
    rank = pr.pull(0.9, 10)
    with BFSStepCheck(torch, rec, bfs, bfsb):
        dist_fused = bfs.pull(0, iters)
        bfs_eng.fused = False      # the split branch, through the same API
        dist_split = bfs.pull(0, iters)
        bfs_eng.fused = True
        dist_bucket = bfsb.pull(0, iters)
        bfsb_eng.fused = False   # the bucket deal's split branch (no K5)
        dist_bucket_split = bfsb.pull(0, iters)
        bfsb_eng.fused = True
    torch.cuda.synchronize()
    engines = (pr_eng, bfs_eng, bfsb_eng)
    rec["K4_planar_fused"]["launches"] = sum(e.launches["fused"]
                                             for e in engines)
    rec["K4_planar_scatter"]["launches"] = sum(e.launches["scatter"]
                                               for e in engines)
    rec["K3_router_reduce"]["launches"] += sum(e.launches["reduce"]
                                               for e in engines)
    rec["K5_planar_xperm"]["launches"] = bfsb_eng.launches["xperm"]
    log(f"phase 8 launches: pagerank {pr_eng.launches} bfs "
        f"{bfs_eng.launches} bfs bucket {bfsb_eng.launches}; K5 on the "
        f"apps' paths {sum(e.launches['xperm'] for e in engines)}")
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
    check_close("pokec bfs bucket split", dist_bucket_split, want_b,
                exact=True)
    log(f"phase 8 bfs pull(0, {iters}) deal=bucket (scale "
        f"{BUCKET_SCALE * args.scale:g}): fused (K4 fused) and split "
        f"(K4 scatter -> K3), no K5, equal to the oracle "
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
        y4e = eng.fused_entries_plain(xt)
        s4 = eng.scatter(xt)
        s4p = eng.scatter_plain(xt)
        s4e = eng.scatter_entries_plain(xt)
        y3 = eng.reduce(s4)
        y3p = eng.reduce_plain(s4)
        torch.cuda.synchronize()
        bit_equal(torch, f"pokec {label}: K4 stream", s4, s4p)
        bit_equal(torch, f"pokec {label}: K4 stream (store form walk)", s4,
                  s4e)
        if exact:
            bit_equal(torch, f"pokec {label}: K4 fused", y4, y4e)
            bit_equal(torch, f"pokec {label}: K4 fused vs K4->K3 plain", y4,
                      y4p)
            bit_equal(torch, f"pokec {label}: K3", y3, y3p)
        for name, y in (("K4 fused", y4), ("K4 fused plain (form)", y4e),
                        ("K4->K3 plain", y4p), ("K3 (K4->K3)", y3),
                        ("K3 plain", y3p)):
            y = y.cpu().numpy()
            if exact:
                y = (y != 0).astype(np.float64)
            err = check_close(f"pokec {label} {name}", y, want, exact)
            log(f"phase 9 {label} {name}: max|y-y64|={err:.3e} "
                f"max|y64|={np.abs(want).max():.6e} ok")
        log(f"phase 9 {label}: K4 stream bit-equal to its plain version "
            f"through the layout and to its store form's walk; ok")
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
    launched = bfsb_eng.launches["xperm"]
    sb, sbp = bfsb_eng.scatter(xb), bfsb_eng.scatter_plain(xb)
    sbe = bfsb_eng.scatter_entries_plain(xb)
    xbb = (xb < 0.05).to(torch.float32)
    yb = bfsb_eng.fused_spmv(xbb)
    torch.cuda.synchronize()
    if bfsb_eng.launches["xperm"] != launched:
        raise AssertionError("bucket K4 scatter or K4 fused launched K5")
    bit_equal(torch, "pokec bucket K4 stream vs K5 -> K4 plain", sb, sbp)
    bit_equal(torch, "pokec bucket K4 stream (store form walk)", sb, sbe)
    for name, yp in (("walk", bfsb_eng.fused_entries_plain(xbb)),
                     ("K4 scatter -> K3", bfsb_eng.fused_plain(xbb))):
        bit_equal(torch, f"pokec bucket ANDOR K4 fused ({name})", yb, yp)
    sbb = bfsb_eng.scatter(xbb)
    y3b, y3bp = bfsb_eng.reduce(sbb), bfsb_eng.reduce_plain(sbb)
    torch.cuda.synchronize()
    bit_equal(torch, "pokec bucket ANDOR K3", y3b, y3bp)
    check_close("pokec bucket ANDOR K3 (K4 scatter -> K3)",
                (y3b != 0).cpu().numpy().astype(np.float64),
                bfsb.SpMV_.compute_reference_results(xbb.cpu().numpy()),
                exact=True)
    log("phase 9 bucket: K5 x2 bit-equal to plain; K4 scatter and ANDOR K4 "
        "fused (x columns resolved at init, no K5) bit-equal to their "
        "forms' walks and to K5 -> K4 scatter (-> K3)'s plain versions; "
        "ANDOR K3 on the bucket stream bit-equal to its plain version and, "
        f"clamped, to the oracle; K3 {group_facts(bfsb_eng)} ok")

    # ---- 10. times ----------------------------------------------------------
    eng, xt = pr_eng, spmv_x
    nnz = eng.nnz
    stream = eng.scatter(xt)
    timed = {
        "K4_planar_fused": (lambda: eng.fused_spmv(xt),
                            lambda: eng.fused_entries_plain(xt)),
        "K4_planar_scatter": (lambda: eng.scatter(xt),
                              lambda: eng.scatter_plain(xt)),
        "K3_router_reduce": (lambda: eng.reduce(stream),
                             lambda: eng.reduce_plain(stream)),
        "K5_planar_xperm": (lambda: bfsb_eng.xperm(xb),
                            lambda: bfsb_eng.xperm_plain(xb)),
    }
    bounds = router_bounds(eng)
    pcsr = pr.SpMV_.csr_matrix_
    set_bound(rec["K4_planar_fused"],
              *mv_bound(pcsr.num_rows, pcsr.num_cols, pcsr.nnz))
    set_bound(rec["K4_planar_scatter"], *bounds["scatter"])
    set_bound(rec["K5_planar_xperm"],
              bfsb_eng.num_col_tiles * 8 * 1024 + 8 * bfsb_eng.num_cols, 0)
    log(f"phase 10 pokec K3 bound on the planar stream: "
        f"{(bounds['reduce'][0] + eng.groups.nbytes()) / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms; K3 {group_facts(eng)}")
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
        f"({gteps(nnz, split_ms)}); bucket ANDOR (K4 fused) "
        f"{bucket_ms:.4f} ms ({gteps(bfsb_eng.nnz, bucket_ms)})")
    rec["K4_planar_fused"]["library_ms"] = library_mv(
        torch, pr.SpMV_.csr_matrix_, xt,
        pr.SpMV_.compute_reference_results(xt.cpu().numpy()))
    log(f"phase 10 pokec library torch.mv (CSR, cuSPARSE) on PageRank's "
        f"MULADD SpMV: {rec['K4_planar_fused']['library_ms']:.4f} ms")
    log(f"phase 10 pokec pagerank: {pr_ms:.4f} ms/iter; bfs pull({iters}): "
        f"{bfs_ms:.4f} ms; card {card}")
    log(f"phase 10 K3 on the pokec free MULADD stream: "
        f"{reduce_reductions(torch, eng, stream)}")
    lib_ms, add_ms = library_reduce(torch, eng, stream)
    log(f"phase 10 pokec library index_add_ (gather + index_add_ into a "
        f"zeroed y) on the same K3 stream: {lib_ms:.4f} ms, index_add_ "
        f"alone {add_ms:.4f} ms")
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
        f"window_groups={eng.out_len // 1024} padded streams r/rows/vals MB="
        f"{slots / 1e6:.1f}/{slots / 1e6:.1f}/{4 * slots / 1e6:.1f} "
        f"windows_with_chunks={int((per_window > 0).sum())}/{len(per_window)}"
        f" median_window_chunks={int(np.median(per_window[per_window > 0]))}"
        f" window0_chunks={int(per_window[0])} top_row_nnz={top_row}")
    log(f"phase 11 {chunked_form(eng, slots)}")
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
        else:
            rec["K6_K7_chunked_muladd"]["err"] = float((y - yp).abs().max())
        log(f"phase 12 {semiring.name} chunked (googleplus): "
            f"{chunked_form(e, e.num_chunks * 1024)}")
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
    with BFSStepCheck(torch, rec, bfs):
        dist = bfs.pull(0, iters)
    torch.cuda.synchronize()
    rec["K6_K7_chunked_muladd"]["launches"] = pr.SpMV_.engine.launches[
        "chunked"]
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
        if name == "arithmetic":
            r = rec["K6_K7_chunked_muladd"]
            r["ms"], r["plain_ms"] = k_ms, p_ms
            r["library_ms"] = gp["library_ms"]
            set_bound(r, chunked_bytes(e, e.num_chunks, e.nnz), 2 * e.nnz)
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


def chunked_form(eng, slots: int) -> str:
    """The chunked kernel's padding-free device form, for the log: its
    init seconds, sizes and device bytes against the padded streams'."""
    import torch
    a = eng.arrays
    padded = (6 * slots + 4 * len(a.code)) / 1e6
    # the kernel's atomics at most: one global per (block, row), one shared
    # per run of equal rows in a thread's 8-entry vector
    _, row = eng.plain_index()
    sizes = (a.blocks[:, 1] - a.blocks[:, 0]).long()
    blk = torch.repeat_interleave(torch.arange(len(sizes), device=row.device),
                                  sizes, output_size=row.numel())
    key = (blk << 40) | (torch.arange(row.numel(), device=row.device) // 8)
    new = torch.ones_like(row, dtype=torch.bool)
    new[1:] = (key[1:] != key[:-1]) | (row[1:] != row[:-1])
    pairs = torch.unique((blk << 32) | row).numel()
    return (f"padding-free form: init {eng.init_seconds:.2f} s, entries "
            f"{a.r.numel()}, segments {a.seg_x.numel()}, blocks "
            f"{a.blocks.shape[0]} (at most {a.max_segments} segments), "
            f"device {a.nbytes() / 1e6:.1f} MB against {padded:.1f} MB of "
            f"padded streams and codes; atomics at most {pairs} global, "
            f"{int(new.sum())} shared")


def planar_form(eng) -> str:
    """The planar engine's derived forms for the log: K4 fused's row form,
    K4p fused's tile form and K4 scatter's store form (which the tropical
    walk's pass 1 does not derive), with their init seconds."""
    forms = [("K4 fused", eng.entries), ("K4p fused", eng.pred_entries)]
    if hasattr(eng, "store_entries"):
        forms.append(("K4 scatter", eng.store_entries))
    return "; ".join([f"derived forms: init {eng.init_seconds:.2f} s",
                      *(form_facts(label, e) for label, e in forms)])


def frontier_x(torch, ncols: int, kind: str, zero: float, rng):
    """A dense frontier on the card: no entry, one column, or 5% of the
    columns active (integer values 1..1000: exact in any fp32 order), the
    semiring zero elsewhere."""
    k = {"empty": 0, "one": 1, "5pct": ncols // 20}[kind]
    x = np.full(ncols, zero, np.float32)
    x[rng.choice(ncols, size=k, replace=False)] = rng.integers(
        1, 1001, k).astype(np.float32)
    return torch.from_numpy(x).to("cuda")


def push_paths(torch, args, gp: dict, pk: dict, ch: dict, rec: dict,
               card: str) -> None:
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
    with BFSStepCheck(torch, rec, bfs):
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
    with BFSStepCheck(torch, rec, bfs, bfsb) as chk:
        runs = {"push fused": bfs.push(0, iters),
                "pull_push fused": bfs.pull_push(0, iters, threshold=0.05)}
        eng.fused = False
        runs["push split"] = bfs.push(0, iters)
        runs["pull_push split"] = bfs.pull_push(0, iters, threshold=0.05)
        eng.fused = True
        dist_bucket = bfsb.push(0, iters)
    torch.cuda.synchronize()
    bfs_step_times(torch, chk, rec, card)
    rec["K4p_planar_fused_pred"]["launches"] = (eng.launches["fused_pred"]
                                                + engb.launches["fused_pred"])
    rec["K4p_planar_scatter_pred"]["launches"] = eng.launches["scatter_pred"]
    rec["K3p_router_reduce_pred"]["launches"] += eng.launches["reduce_pred"]
    log(f"phase 15 launches: pokec bfs {eng.launches} bfs bucket "
        f"{engb.launches}; K5 on the apps' paths "
        f"{eng.launches['xperm'] + engb.launches['xperm']}")
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
    act = seng.tile_activity(
        sssp._init_state(sssp._internal_source(0), 0)[0])
    log(f"phase 16 sssp SpMSpV layout (chunk_order=col): "
        f"chunks={seng.num_chunks} batches={seng.num_chunks // 32} "
        f"col_tiles={seng.nct}; a 1-vertex frontier keeps "
        f"{int(seng.kept_batches(act).sum())} batches, "
        f"{int(seng.active_chunks(act).sum())} chunks")
    want = sssp.compute_reference_results(0, iters)
    want_small = small.compute_reference_results(0, iters)
    reset((seng, beng, sssp))
    with SSSPKernelCheck(torch) as chk:
        runs = {"push": sssp.push(0, iters)}
        if chk.calls != iters:
            raise AssertionError(f"sssp push(0, {iters}) relaxed "
                                 f"{chk.calls} times")
        runs["pull_push"] = sssp.pull_push(0, iters)
    dist_small = small.push(0, iters)
    torch.cuda.synchronize()
    if sssp.launches["relax"] != chk.calls:
        raise AssertionError(f"sssp launches {dict(sssp.launches)}, relax "
                             f"calls {chk.calls}")
    rec["K7p_chunked_pred"]["launches"] = (seng.launches["chunked_pred"]
                                           + beng.launches["chunked_pred"])
    rec["sssp_relax"]["launches"] = sssp.launches["relax"]
    log(f"phase 16 launches: sssp SpMSpV {seng.launches} small bfs SpMSpV "
        f"{beng.launches} sssp {dict(sssp.launches)}: one relax a push step "
        f"({iters} for push, {chk.calls - iters} for pull_push), each "
        f"bit-equal to its plain version on its own inputs")
    sssp_relax_times(torch, chk, rec, card)
    for label, dist in runs.items():
        check_close(f"sssp {label}", dist, want, exact=True)
    check_close("small bfs push", dist_small, want_small, exact=True)
    log(f"phase 16 sssp push(0, {iters}) and pull_push(0, {iters}): equal to "
        f"the oracle ({int((want < float(FLOAT_INF)).sum())} reached); bfs "
        f"push(0, {iters}) at scale {0.1 * args.scale:g} on K7p (ANDOR) "
        f"equal to the oracle; ok")


def sssp_relax_times(torch, chk: SSSPKernelCheck, rec: dict,
                     card: str) -> None:
    """Phase 16's time of SSSP's relax kernel on the main path's last push
    step's y and distance (repeated calls move the same bytes), beside
    its plain version and its bound."""
    from graphlily_tpu_torch.ops import _build
    m = chk.mod
    y0, d0 = chk.last
    n = d0.numel()
    launches = _build.Launches("sssp", ("relax",))
    y, d = y0.clone(), d0.clone()
    slot = torch.zeros(1, dtype=torch.int32, device=d0.device)
    r = rec["sssp_relax"]
    r["err"] = 0.0   # bit-equal on every launch (SSSPKernelCheck)
    r["ms"] = time_ms(torch, lambda: m.relax(y, d, slot[0], launches))
    r["plain_ms"] = time_ms(torch, lambda: m.relax_plain(y0, d0))
    set_bound(r, 16 * n, n)
    us = device_us(torch, lambda: m.relax(y, d, slot[0], launches),
                   "sssp_relax_kernel")
    log(f"phase 16 sssp_relax (n={n}): {r['ms']:.4f} ms a wrapper call, "
        f"device {us:.2f} us a launch; plain {r['plain_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {16 * n / 1e6:.2f} MB); "
        f"card {card}")


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
        # K1p's and K4p fused's plain versions walk a derived form (K1's
        # row form; the planar tile form), K4p scatter's its store form;
        # each kernel is also held to the plain versions through the
        # layout (K2p/K4p scatter -> K3)
        fused_plain = (lambda x, a: eng.fused_entries_plain(
            x, a, eng.pred_plain_entries()))
        for kind in ("empty", "one", "5pct"):
            xt = frontier_x(torch, eng.num_cols, kind, 0.0, rng)
            act = eng.activity(xt)
            live = eng.live_chunks(act)
            s, sp = eng.scatter_predicated(xt, act), eng.scatter_plain(
                xt, None, act)
            if hasattr(eng, "store_entries"):
                bit_equal(torch, f"{label} {kind} scatter (store form)", s,
                          eng.scatter_entries_plain(xt, act))
            y3, y3p = eng.reduce_predicated(s, live), eng.reduce_plain(
                s, None, live)
            y1, y1p = eng.fused_predicated(xt, act), fused_plain(xt, act)
            full = eng.fused_spmv(xt)
            torch.cuda.synchronize()
            bit_equal(torch, f"{label} {kind} scatter", s, sp)
            bit_equal(torch, f"{label} {kind} fused vs K2p->K3 plain", y1,
                      eng.fused_plain(xt, None, act))
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
            ("fused", lambda: fused_plain(xt, act)),
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
                   roll.fused_entries_plain(xt, act), roll.fused_spmv(xt))
    torch.cuda.synchronize()
    scale = float(yp.abs().max())
    for label, ref in (("plain", yp), ("unpredicated", full),
                       ("K2p->K3 plain", roll.fused_plain(xt, None, act))):
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
    log("phase 17 pokec planar bucket ANDOR 5%: K4p fused and K4p scatter "
        "(no K5) bit-equal to plain and unpredicated ok")

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
        real = int(act.bool()[seng.plain_index()[0] // 1024].sum())
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

    # the push apps' times, with the steps of a profiled pull_push
    apps = (("googleplus bfs", gp["bfs"], "googleplus"),
            ("pokec bfs", pk["bfs"], "pokec"),
            ("googleplus sssp", ch["sssp"], "googleplus"))
    for label, app, graph in apps:
        iters = ICCAD_GRAPHS[graph]["iters"]
        ms = {name: time_ms(torch, lambda: fn(0, iters, device_output=True),
                            iters=5, reps=3)
              for name, fn in (("pull", app.pull), ("push", app.push),
                               ("pull_push", app.pull_push))}
        steps = step_spans(torch, lambda: app.pull_push(
            0, iters, device_output=True))
        log(f"phase 17 {label}({iters}): pull {ms['pull']:.4f} ms, push "
            f"{ms['push']:.4f} ms, pull_push {ms['pull_push']:.4f} ms "
            f"({steps}); card {card}")


def tropical_bounds(eng) -> dict:
    """(bytes, ops) of the tropical split (K8 or K9) and window reduce
    (K10) on this layout: every entry passes each once. The split reads
    its g1 element and its source byte (K8: the plane entry; K9: the sort
    plane's int32), every descriptor slot's words (rg2, target; K9 also 32
    B of run words) and in_order, and writes the whole window stream g2;
    plane bytes of empty lanes are not counted. K10 reads each entry's g2
    value, sort and row bytes and c_win, writes out, and does one max an
    entry."""
    nel = eng.walk.nnz
    slots = eng.nsteps2 * eng.dstep2
    desc = slots * (12 + (32 if eng.triples else 0)) + 4 * eng.nsteps2 * eng.kb
    split = nel * (8 if eng.triples else 5) + desc + 4 * eng.nchunks2 * 1024
    reduce = 6 * nel + 4 * eng.nchunks2 + 4 * eng.num_windows * 128
    return {"split": (split, 0), "window_reduce": (reduce, nel)}


def tropical_facts(eng) -> str:
    """The layout facts of a tropical engine's three passes
    (`TropicalStages`), for the log."""
    p = eng.walk.planar
    a = eng.arrays
    deposit = (a.xsort2.numel() * 4 + a.tri2.numel() * 4 if eng.triples
               else a.split.nbytes())
    live = int((a.rg2[:, :eng.dstep2, 1] > 0).sum())
    return (f"region_rows={p.region_rows} digits={p.region_rows // 128} "
            f"regions={p.num_regions} pass1 nsteps={p.nsteps} f={p.f} "
            f"g1_MB={p.nsteps * p.f * 4096 / 1e6:.1f} split "
            f"format={'triples' if eng.triples else 'planes'} "
            f"nsteps2={eng.nsteps2} kb={eng.kb} rstep2={eng.rstep2} "
            f"dstep2={eng.dstep2} f2={eng.f2} "
            f"nblocks2={eng.nchunks2 // eng.f2} pieces={live} "
            f"fill2={eng.walk.nnz / (eng.nchunks2 * 1024):.3f} "
            f"split_deposit_MB={deposit / 1e6:.1f} "
            f"g2_MB={eng.nchunks2 * 4096 / 1e6:.1f}")


def check_walk_only(label: str, launches: dict) -> None:
    """An SSSP run on the tropical engine launched its walk (K4 fused and
    K4p fused in ADDMIN mode), the engine's only kernels."""
    if set(launches) != {"fused", "fused_pred"} or not all(
            launches.values()):
        raise AssertionError(f"{label} launches {launches}: the engine is "
                             "the walk, and both walks must run")


def walk_is_three_pass(torch, label: str, stages, out, three) -> None:
    """The walk's out (the pass-1 regions' rows) holds K10's out (the
    windows' rows) as its prefix, bit for bit, and 0 past it."""
    n = stages.num_windows * 128
    if (out.dtype != torch.int32
            or out.numel() != stages.walk.planar.out_len
            or not torch.equal(out[:n], three) or bool(out[n:].any())):
        raise AssertionError(f"{label} differs from the three passes' out")


def walk_bound(torch, eng, act=None) -> tuple:
    """(bytes, ops) of the tropical SpMV y = min(A + x) as a function, as
    mv_bound counts the MULADD one: each entry's 4 B value and 4 B column,
    a 4 B row word a row, x read once and y written once; an add and a
    min an entry. With `act` (tile activity), the entries and x of the
    active tiles only, counted from the tile form's segments."""
    elems, xbytes = eng.nnz, 4 * eng.num_cols
    if act is not None:
        e = eng.planar.pred_entries
        first = torch.cat([e.deps[:, 0].long(),
                           e.deps.new_tensor([e.idx.numel()]).long()])
        on = act.bool()[e.deps[:, 3].long()]
        elems = int((first[1:] - first[:-1])[on].sum())
        xbytes = 4 * eng.ACT_COLS * int(act.sum())
    return (8 * elems + 4 * (eng.num_rows + 1) + xbytes + 4 * eng.num_rows,
            2 * elems)


def decoded_err(a, b) -> float:
    """max |a - b| of two int32 encoding tensors, decoded to float32."""
    from graphlily_tpu_torch.semiring import tropical_decode
    return float((tropical_decode(a) - tropical_decode(b)).abs().max())


def tropical(torch, args, rec: dict, card: str, pk: dict) -> None:
    """Phases 18-20: SSSP on the tropical engine (pokec; googleplus at
    TRIPLES_SCALE), the three passes built beside it (`TropicalStages`:
    pokec planes, googleplus triples), each kernel against its plain
    version, and times."""
    from graphlily_tpu_torch import (EngineConfig, FLOAT_INF,
                                     TropicalSemiring)
    from graphlily_tpu_torch.apps import SSSP
    from graphlily_tpu_torch.io import (ICCAD_GRAPHS, iccad_standin,
                                        pack_tropical_schedule)
    from graphlily_tpu_torch.module import SpMVModule, spmv_module
    from graphlily_tpu_torch.ops import TropicalStages
    dev = torch.device("cuda")
    inf = float(FLOAT_INF)
    iters = ICCAD_GRAPHS["pokec"]["iters"]

    def load(graph, cfg):
        """An SSSP app formatted for `graph`, its SpMV module's formatting
        (pack + engine init) timed apart from the whole load, and the
        pass-1 layout its ladder packed."""
        app = SSSP(cfg)
        inner, secs = app.SpMV_.load_and_format_matrix, {}
        pack, packed = spmv_module.pack_tropical_pass1, []

        def timed(*a, **kw):
            t = time.perf_counter()
            inner(*a, **kw)
            secs["pack"] = time.perf_counter() - t
        app.SpMV_.load_and_format_matrix = timed
        spmv_module.pack_tropical_pass1 = (
            lambda *a, **kw: packed.append(pack(*a, **kw)) or packed[-1])
        t0 = time.perf_counter()
        try:
            app.load_and_format_matrix(graph)
        finally:
            spmv_module.pack_tropical_pass1 = pack
        secs["load"] = time.perf_counter() - t0
        eng = app.SpMV_.engine
        if app.SpMV_.engine_name != "tropical":
            raise AssertionError(f"SSSP resolved {app.SpMV_.engine_name!r}, "
                                 "not tropical")
        if app.SpMSpV_.engine is not eng or len(packed) != 1:
            raise AssertionError(f"SSSP's SpMSpV does not share the tropical "
                                 f"engine ({len(packed)} pass-1 packs)")
        return app, eng, secs, packed[0]

    def stages(pass1, cfg, split_format):
        """The three passes over the pass 1 the app's walk was built on,
        and their schedule pack + init seconds."""
        t = time.perf_counter()
        st = TropicalStages(pack_tropical_schedule(
            pass1, split_format=split_format), cfg)
        torch.cuda.synchronize()
        if st.triples != (split_format == "triples"):
            raise AssertionError(f"the three passes are not in the "
                                 f"{split_format} format")
        return st, time.perf_counter() - t

    # ---- 18. main path: pokec SSSP pull, push and pull_push -----------------
    # the ladder picks the tropical engine at full size (1.63M rows > 700k);
    # a shrunken graph asks for it by name
    engine = "auto" if args.scale >= 1 else "router"
    cfg = EngineConfig(sort_rows_by_degree=True, engine=engine)
    sssp, eng, secs, pass1 = load(pk["g"], cfg)
    log(f"phase 18 pokec sssp (scale={args.scale}): engine={engine} -> "
        f"tropical, SpMSpV shares it; relabel+self edges+pack+init "
        f"{secs['load']:.1f} s, of which pass-1 pack+init "
        f"{secs['pack']:.1f} s (the walk's forms {eng.init_seconds:.2f} "
        f"s); nnz={eng.nnz}; pass 1 {planar_form(eng.planar)}")
    reset((eng, sssp))
    with SSSPKernelCheck(torch) as chk:
        runs = {"pull": sssp.pull(0, iters), "push": sssp.push(0, iters),
                "pull_push": sssp.pull_push(0, iters, threshold=0.05)}
    torch.cuda.synchronize()
    if sssp.launches["relax"] != chk.calls or chk.calls < iters:
        raise AssertionError(f"pokec sssp launches {dict(sssp.launches)}, "
                             f"relax calls {chk.calls}")
    rec["sssp_relax"]["launches"] += sssp.launches["relax"]
    log(f"phase 18 launches: pokec sssp {dict(sssp.launches)}, each relax "
        f"bit-equal to its plain version on its own inputs")
    launches = dict(eng.launches)
    check_walk_only("pokec sssp", launches)
    rec["K4_planar_fused_addmin"]["launches"] = launches["fused"]
    rec["K4p_planar_fused_pred_addmin"]["launches"] = launches["fused_pred"]
    log(f"phase 18 launches: pokec sssp {launches} (the walk only)")
    t0 = time.perf_counter()
    want = sssp.compute_reference_results(0, iters)
    oracle_s = time.perf_counter() - t0
    for label, dist in runs.items():
        check_close(f"pokec sssp {label}", dist, want, exact=True)
    log(f"phase 18 pokec sssp pull(0, {iters}), push(0, {iters}) and "
        f"pull_push(0, {iters}, 0.05): equal to the float64 oracle "
        f"({int((want < inf).sum())} reached, oracle {oracle_s:.1f} s) ok")

    # ---- 19. each kernel against its plain version --------------------------
    st, st_s = stages(pass1, cfg, "auto")
    log(f"phase 19 pokec three passes (split format auto): schedule "
        f"pack+init {st_s:.1f} s (the store form and K8's "
        f"{st.init_seconds:.2f} s); "
        f"{tropical_facts(st)}")
    rng = np.random.default_rng(19)
    x = rng.integers(0, 1000, eng.num_cols).astype(np.float32)
    x[rng.random(eng.num_cols) < 0.5] = inf    # integers: exact fp32 sums
    xt = torch.from_numpy(x).to(dev)
    walk, walkp = eng.fused(xt), eng.fused_plain(xt)
    g1, g1p = st.scatter(xt), st.scatter_plain(xt)
    g1e = st.walk.planar.scatter_entries_plain(xt)
    g2, g2p = st.split(g1), st.split_plain(g1)
    out, outp = st.window_reduce(g2), st.window_reduce_plain(g2)
    torch.cuda.synchronize()
    bit_equal(torch, "pokec tropical walk", walk, walkp)
    walk_is_three_pass(torch, "pokec tropical walk", st, walk, out)
    bit_equal(torch, "pokec K4 scatter ADDMIN stream", g1, g1p)
    bit_equal(torch, "pokec K4 scatter ADDMIN stream (store form walk)", g1,
              g1e)
    bit_equal(torch, "pokec K8 window stream", g2, g2p)
    bit_equal(torch, "pokec K10 out", out, outp)
    rec["K4_planar_fused_addmin"]["err"] = decoded_err(walk, walkp)
    rec["K4_planar_scatter_addmin"]["err"] = decoded_err(g1, g1p)
    rec["K8_tropical_split"]["err"] = decoded_err(g2, g2p)
    rec["K10_tropical_window_reduce"]["err"] = decoded_err(out, outp)
    check_close("pokec tropical engine call", eng(xt).cpu().numpy(),
                sssp.SpMV_.compute_reference_results(x), exact=True)
    log("phase 19 pokec: the walk bit-equal to its plain version and to the "
        "three kernels' out (K4 scatter ADDMIN -> K8 -> K10); K4 scatter "
        "ADDMIN stream, K8 window stream and K10 out bit-equal to their "
        "plain versions; engine call equal to the oracle ok")
    times = {}
    for kind in ("empty", "one", "5pct"):
        xf = frontier_x(torch, eng.num_cols, kind, inf, rng)
        act = eng.activity(xf)
        w, wp, wfull = (eng.fused_predicated(xf, act),
                        eng.fused_plain(xf, act), eng.fused(xf))
        s, sp, full = (st.scatter_predicated(xf, act),
                       st.scatter_plain(xf, act), st.scatter(xf))
        three = st.window_reduce(st.split(full))
        y, yfull = eng.call_predicated(xf), eng(xf)
        torch.cuda.synchronize()
        bit_equal(torch, f"pokec predicated walk {kind}", w, wp)
        bit_equal(torch, f"pokec predicated walk {kind} vs unpredicated", w,
                  wfull)
        walk_is_three_pass(torch, f"pokec predicated walk {kind}", st, w,
                           three)
        bit_equal(torch, f"pokec K4p ADDMIN {kind}", s, sp)
        bit_equal(torch, f"pokec K4p ADDMIN {kind} (store form walk)", s,
                  st.walk.planar.scatter_entries_plain(xf, act))
        bit_equal(torch, f"pokec K4p ADDMIN {kind} vs unpredicated", s, full)
        bit_equal(torch, f"pokec tropical SpMSpV {kind} vs SpMV", y, yfull)
        walk_ms = time_ms(torch, lambda: eng.fused_predicated(xf, act))
        ms = time_ms(torch, lambda: st.scatter_predicated(xf, act))
        call_ms = time_ms(torch, lambda: eng.call_predicated(xf))
        three_ms = time_ms(torch, lambda: st.window_reduce(st.split(
            st.scatter_predicated(xf, act))))
        wbytes, wops = walk_bound(torch, eng, act)
        nbytes, nops = router_bounds(st.walk.planar, act)["scatter"]
        log(f"phase 19 pokec tropical SpMSpV {kind}: active tiles "
            f"{int(act.sum())}/{eng.num_col_tiles}; predicated walk "
            f"{walk_ms:.4f} ms (bound {wbytes / HBM_BYTES_PER_S * 1e3:.6f}),"
            f" SpMSpV call {call_ms:.4f} ms, the three passes it replaces "
            f"(K4p scatter -> K8 -> K10) {three_ms:.4f} ms; K4p scatter "
            f"{ms:.4f} ms (bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f}); "
            f"bit-equal to plain, to unpredicated and to the three passes ok")
        times[kind] = (ms, s, sp, walk_ms, w, wp, (wbytes, wops))
    r = rec["K4p_planar_scatter_pred_addmin"]
    r["ms"], r["err"] = times["5pct"][0], decoded_err(*times["5pct"][1:3])
    r["plain_ms"] = time_ms(torch, lambda: st.scatter_plain(xf, act),
                            iters=10)
    set_bound(r, nbytes, nops)
    r = rec["K4p_planar_fused_pred_addmin"]
    r["ms"], r["err"] = times["5pct"][3], decoded_err(*times["5pct"][4:6])
    r["plain_ms"] = time_ms(torch, lambda: eng.fused_plain(xf, act),
                            iters=10)
    set_bound(r, *times["5pct"][6])

    # K9 on the googleplus stand-in cut to TRIPLES_SCALE (pass-1 triples
    # too), which keeps the whole run near 750 s since PERM-C joined it
    giters = ICCAD_GRAPHS["googleplus"]["iters"]
    gscale = TRIPLES_SCALE * args.scale
    gcfg = EngineConfig(sort_rows_by_degree=True, engine="router")
    gsssp, geng, gsecs, gpass1 = load(
        iccad_standin("googleplus", scale=gscale, seed=0), gcfg)
    gst, gst_s = stages(gpass1, gcfg, "triples")
    log(f"phase 19 googleplus sssp (scale {gscale:g}), engine=router: "
        f"relabel+self edges+pack+init {gsecs['load']:.1f} s, of which "
        f"pass-1 pack+init {gsecs['pack']:.1f} s; nnz={geng.nnz}; three "
        f"passes (split format triples) schedule pack+init {gst_s:.1f} s; "
        f"{tropical_facts(gst)}")
    reset((geng,))
    gruns = {"pull": gsssp.pull(0, giters), "push": gsssp.push(0, giters)}
    torch.cuda.synchronize()
    check_walk_only("googleplus sssp", geng.launches)
    log(f"phase 19 launches: googleplus sssp {geng.launches} (the walk "
        f"only)")
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
    h1 = gst.scatter(xg)
    h2, h2p = gst.split(h1), gst.split_plain(h1)
    hout = gst.window_reduce(h2)
    hwalk = geng.fused(xg)
    torch.cuda.synchronize()
    bit_equal(torch, "googleplus K4 scatter ADDMIN (triples)", h1,
              gst.scatter_plain(xg))
    bit_equal(torch, "googleplus K9 window stream", h2, h2p)
    bit_equal(torch, "googleplus K10 out", hout, gst.window_reduce_plain(h2))
    bit_equal(torch, "googleplus tropical walk", hwalk, geng.fused_plain(xg))
    walk_is_three_pass(torch, "googleplus tropical walk", gst, hwalk, hout)
    rec["K9_tropical_split_triples"]["err"] = decoded_err(h2, h2p)
    log(f"phase 19 googleplus: sssp pull(0, {giters}) and push(0, {giters}) "
        f"equal to the oracle; the tropical and chunked engine calls equal "
        f"to the oracle; K4 scatter ADDMIN, K9 and K10 bit-equal to their "
        f"plain versions, the walk to its plain version and to K10's out "
        f"ok")

    # ---- 20. times ------------------------------------------------------------
    bounds = tropical_bounds(st)
    timed = {
        "K4_planar_fused_addmin": (lambda: eng.fused(xt),
                                   lambda: eng.fused_plain(xt),
                                   walk_bound(torch, eng)),
        "K4_planar_scatter_addmin": (lambda: st.scatter(xt),
                                     lambda: st.scatter_plain(xt),
                                     router_bounds(st.walk.planar)[
                                         "scatter"]),
        "K8_tropical_split": (lambda: st.split(g1),
                              lambda: st.split_plain(g1), bounds["split"]),
        "K10_tropical_window_reduce": (lambda: st.window_reduce(g2),
                                       lambda: st.window_reduce_plain(g2),
                                       bounds["window_reduce"]),
        "K9_tropical_split_triples": (lambda: gst.split(h1),
                                      lambda: gst.split_plain(h1),
                                      tropical_bounds(gst)["split"]),
    }
    for name, (kernel, plain, (nbytes, nops)) in timed.items():
        r = rec[name]
        r["ms"] = time_ms(torch, kernel)
        r["plain_ms"] = time_ms(torch, plain, iters=10)
        set_bound(r, nbytes, nops)
        log(f"phase 20 {name}: {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
            f"ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)")
    split = st.arrays.split
    live = split.pieces.shape[0]
    log(f"phase 20 K8 reads its compact form, not the planes: {live} "
        f"pieces, {split.lanes.numel()} elements, {split.nbytes() / 1e6:.1f}"
        f" MB (the planes it was derived from: {live} x 1 KB = "
        f"{live * 1024 / 1e6:.1f} MB of live planes), derived with the "
        f"store form in {st.init_seconds:.2f} s")
    call_ms = time_ms(torch, lambda: eng(xt))
    three_ms = time_ms(torch, lambda: st.window_reduce(st.split(
        st.scatter(xt))))
    p = eng.planar
    log(f"phase 20 pokec tropical engine call (the walk + decode): "
        f"{call_ms:.4f} ms ({gteps(eng.nnz, call_ms)}); the three passes "
        f"it replaces (K4 scatter -> K8 -> K10, no decode): {three_ms:.4f} "
        f"ms; the walk's forms: row {p.entries.nbytes() / 1e6:.1f} MB, tile "
        f"{p.pred_entries.nbytes() / 1e6:.1f} MB, derived in "
        f"{p.init_seconds:.2f} s")
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
    steps = step_spans(torch, lambda: sssp.pull_push(
        0, iters, device_output=True))
    log(f"phase 20 pokec sssp({iters}): pull {ms['pull']:.4f} ms, push "
        f"{ms['push']:.4f} ms, pull_push {ms['pull_push']:.4f} ms "
        f"({steps}); card {card}")

def muladd_oracle(csr, x: np.ndarray) -> np.ndarray:
    """Float64 y = A x over the CSR matrix's rows."""
    nnz = csr.nnz
    return np.bincount(csr.row_ids(), minlength=csr.num_rows,
                       weights=csr.adj_data[:nnz].astype(np.float64)
                       * x[csr.adj_indices[:nnz]].astype(np.float64))


def permc_bounds(eng, act=None) -> dict:
    """(bytes, ops) of K11 or K11p and of K4 fused on a PERM-C layout.
    K11p reads, per live flushed chunk, its 4 KB of stream, its 3 KB of
    int8 destination-lane keys and its code, writes y once, and adds each
    element of the live chunks once; K11, K3's kernel, reads K3's bytes
    (router_bounds: 2 B of position-keyed rows a slot) and the
    region-group table; K4p fused is router_bounds' count (K4 fused's is
    mv_bound's)."""
    t = router_traffic(eng, act)
    if act is None:
        nbytes, nops = router_bounds(eng)["reduce"]
        reduce = (nbytes + eng.groups.nbytes(), nops)
    else:
        reduce = (t["live"] * (7 * 1024 + 4) + t["y"], t["elems"])
    return {"reduce": reduce,
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
    log(f"phase 21 pokec bfs PERM-C {planar_form(eng)}")
    t0 = time.perf_counter()
    muladd = PlanarSpMV(layouts[-1], ArithmeticSemiring,
                        EngineConfig(device="cuda"))
    del layouts[:]
    log(f"phase 21 MULADD engine on the same layout: init "
        f"{time.perf_counter() - t0:.1f} s; {planar_form(muladd)}; K11 "
        f"{group_facts(muladd)}")
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
    with BFSStepCheck(torch, rec, bfs):
        dists = {"pull fused": bfs.pull(0, iters),
                 "push fused": bfs.push(0, iters),
                 "pull_push fused": bfs.pull_push(0, iters, threshold=0.05)}
        eng.fused = False          # the split branch, through the same API
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
    se = muladd.scatter_entries_plain(xt)
    y11, y11p = muladd.reduce(s), muladd.reduce_plain(s)
    y4, y4p = muladd.fused_spmv(xt), muladd.fused_plain(xt)
    y4e = muladd.fused_entries_plain(xt)
    torch.cuda.synchronize()
    bit_equal(torch, "PERM-C MULADD K4 stream", s, sp)
    bit_equal(torch, "PERM-C MULADD K4 stream (store form walk)", s, se)
    for label, y in (("K4 scatter -> K11", y11), ("K11 plain", y11p),
                     ("K4 fused PERM-C", y4), ("K4 fused plain (form)", y4e),
                     ("K4->K3 plain", y4p),
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
    y4a = eng.fused_spmv(xat)
    pairs = (("K11", eng.reduce(sa), eng.reduce_plain(sa)),
             ("K4 fused PERM-C", y4a, eng.fused_plain(xat)),
             ("K4 fused PERM-C (form)", y4a, eng.fused_entries_plain(xat)))
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
        y4w = eng.fused_entries_plain(xf, act, eng.pred_plain_entries())
        full = eng.fused_spmv(xf)
        torch.cuda.synchronize()
        bit_equal(torch, f"PERM-C {kind} K4p scatter (store form)", sf,
                  eng.scatter_entries_plain(xf, act))
        for label, y, yp in (("K11p", y11, y11p), ("K4p fused", y4, y4p),
                             ("K4p fused (tile form walk)", y4, y4w)):
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
                         .abs().max()),
            "K4p (tile form walk)": float((y4m - muladd.fused_entries_plain(
                xf, act_m, muladd.pred_plain_entries())).abs().max())}
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
        torch, lambda: eng.fused_entries_plain(xf, act,
                                               eng.pred_plain_entries()),
        iters=10)
    bounds = permc_bounds(muladd)
    bcsr = bfs.SpMV_.csr_matrix_
    timed = {"K11_permc_reduce": (lambda: muladd.reduce(s),
                                  lambda: muladd.reduce_plain(s),
                                  bounds["reduce"]),
             "K4_planar_fused_permc": (lambda: muladd.fused_spmv(xt),
                                       lambda: muladd.fused_entries_plain(xt),
                                       mv_bound(bcsr.num_rows, bcsr.num_cols,
                                                bcsr.nnz))}
    for name, (kernel, plain, (nbytes, nops)) in timed.items():
        r = rec[name]
        r["ms"] = time_ms(torch, kernel)
        r["plain_ms"] = time_ms(torch, plain, iters=10)
        set_bound(r, nbytes, nops)
        log(f"phase 22 {name}: {r['ms']:.4f} ms ({gteps(muladd.nnz, r['ms'])})"
            f" plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / 1e6:.1f} MB)")
    log(f"phase 22 K11 on the PERM-C MULADD stream: "
        f"{reduce_reductions(torch, muladd, s)}")
    lib_ms, add_ms = library_reduce(torch, muladd, s)
    rec["K11_permc_reduce"]["library_ms"] = lib_ms
    log(f"phase 22 library index_add_ (gather + index_add_ into a zeroed y) "
        f"on the same K11 stream: {lib_ms:.4f} ms, index_add_ alone "
        f"{add_ms:.4f} ms")
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
