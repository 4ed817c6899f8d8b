#!/usr/bin/env python3
"""Old/new A/B of the chunked kernel (K6/K7, K7p), K4 fused, K4 scatter
(K4p scatter), K4p fused, K1 (K1p), K8 and the tropical engine's walk on
one GPU, and the sizes their device forms are cut to.

Packs the full stand-ins once with this tree's packers (which are
array-equal to every earlier tree's), builds each kernel's engine from the
same layout with this tree's package and with the package of an older
tree (`--parent DIR`: a directory holding that tree's
graphlily_tpu_torch/, e.g. unpacked from `git archive`), checks each
pair's outputs against each other, and times them in turns: old, new,
new, old (CUDA events, min over 5 reps of 100 calls each). Rows:

  chunked ADDMIN   googleplus SSSP's layout (self edges, degree-sorted)
  chunked MULADD   googleplus, engine="pallas", degree-sorted
  K7p ADDMIN       SSSP's SpMSpV layout (chunk_order="col") at empty,
                   1-vertex and 5% frontiers
  K4 fused         pokec PageRank's "free" layout, MULADD and ANDOR (a
                   5% 0/1 x), beside torch.mv on the same MULADD SpMV,
                   this tree's form at column windows of 2**11-2**18
                   columns and 2,048 and 8,192 elements a block, ANDOR
                   with its value stream and, with `--ablations`, K1's
                   ablation trees on the same form
  K4 fused PERM-C  pokec BFS's PERM-C layout, the same rows
  K4p fused        ("planar") ANDOR engines on both layouts, empty,
                   1-vertex and 5%
  K4 scatter       ("scatter") pokec: "free" MULADD and ANDOR, "bucket"
                   (BFS's layout of the full stand-in) MULADD, PERM-C
                   MULADD, and the tropical engine's ADDMIN pass 1 (SSSP's
                   layout), each beside the zero fill of the flush stream
                   alone, the kernel after that fill in place of its own
                   zeros of the unfilled lanes (no tails), the kernel alone
                   into a stream allocated once, and, with `--ablations`,
                   the store walk with a constant
                   for its x gather; K4p scatter ANDOR ("free") and ADDMIN
                   (pass 1) at empty, 1-vertex and 5% frontiers
  K4p fused        ("tile") ANDOR on pokec "free" and PERM-C at empty,
                   1-vertex and 5% frontiers: the tile form (windows of
                   2**10 columns) against windows of 2**11-2**13 columns
                   (each flagged by its window, with the tile activity
                   folded to windows), the piece-ordered form (K1p's
                   "deposit" order) and K4 fused's whole product
  K1 MULADD/ANDOR  googleplus, degree-sorted (the PageRank and BFS layout),
                   beside torch.mv (cuSPARSE) on the same MULADD SpMV, K1
                   over the deposit-ordered form (K1p's), at 2,048 and
                   8,192 elements a block, at column windows of 2**12,
                   2**13, 2**14 and 2**16 columns (K4 fused's widths
                   against the one window the word leaves, 2**18), and,
                   with `--ablations`, this
                   tree's kernel built from patched copies of its source
                   (ABLATIONS): the y atomics as plain stores, the x
                   gather as a constant
  K1p ANDOR        the same layout at empty, 1-vertex and 5% frontiers
  K8               pokec SSSP's tropical layout ("planes"), beside K9 on
                   triples derived from the same planes
                   (io/tropical_format.derive_split_triples), the zero
                   fill of the window stream alone (inside K8's call) and,
                   with `--ablations`, K8 without its stores and without
                   its g1 gather
  reduce           ("reduce") phase C of the split branch: K3 on the
                   googleplus roll stream and on pokec's "free" planar
                   stream, K11 on the MULADD stream of pokec BFS's PERM-C
                   layout (each stream written once by this tree's K2 or
                   K4 scatter): first, with `--ablations`, the parent's
                   kernels against themselves with their global atomics as
                   plain stores (timing only); then old against new, this
                   tree's region-group table at 4, 8, 16, 32, 64 and
                   128 chunks a group, and, with `--ablations`, the flush
                   variants (scalar atomics for the vector reductions;
                   vector reductions for the sole groups' stores); and the
                   split engine call (scatter -> reduce) old against new. This tree's K11 is K3's kernel
                   over the PERM-C layout's position-keyed rows; time the
                   destination-lane design it replaced with `--variant`
                   on a tree that has it
  walk             ("walk") the tropical engine call on pokec SSSP's layout
                   ("planes"): the parent's three passes (K4 scatter ADDMIN
                   -> K8 -> K10) against this tree's walk (K1's kernel in
                   ADDMIN mode over the pass-1 row form), pull and
                   SpMSpV at empty, 1-vertex and 5% frontiers (the tile
                   form), the walk's row form at column windows of 2**13,
                   2**14 and 2**15 columns, the row and tile forms' MB and
                   init seconds, and K10 alone (the same kernel in both
                   trees)

`--graphs graph500` (beside or in place of `standin`) adds the K1, K4
fused and walk rows (`--kernels router planar walk`) on the benchmark's
own graphs, drawn on the card by bench_torch's Kronecker generator from
one seed and formatted as their cells format them: K1 on
graph500-s18's PageRank layout (the roll router), K4 fused and K4p fused
on graph500-s19's ("free"), the tropical engine call and SpMSpV on
graph500-s19-k3's SSSP layout. Each tree's K1 kernels are logged first
with the registers and spills ptxas reported and the blocks an SM holds
by registers.

`--entries E ...` also times this tree's chunked kernel with other block
sizes (real entries per block). Prints one line per row and writes them
to chiprun_out/ab_kernels.json.

`--variant DIR ...` adds more trees to the same turns (each variant
before and after the new tree, as the parent).

Usage: python3 ab_kernels.py --parent _archive_check/parent [--scale S]
       [--variant DIR ...] [--entries 1024 2048 4096]
       [--kernels chunked planar router tropical scatter tile walk reduce]
       [--graphs standin graph500] [--ablations]
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNELS = ["chunked", "planar", "router", "tropical", "scatter", "tile",
           "walk", "reduce"]
GRAPHS = ["standin", "graph500"]


def log(msg: str) -> None:
    print(msg, flush=True)


def load_package(root: Path, name: str):
    """The graphlily_tpu_torch package under `root`, imported as `name`,
    with its `ops` subpackage (and `ops._build`) loaded."""
    pkg = root / "graphlily_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    mod = sys.modules[name]
    for sub in ("ops", "ops._build", "ops.chunked", "ops.planar",
                "ops.router", "ops.tropical"):
        importlib.import_module(f"{name}.{sub}")
    return mod


# Ablations of K1, K8, K4 scatter and phase C: name -> (source under
# csrc/, [(old, new)]); K1's atomics as plain stores, its x gather as a
# constant; K8's stores skipped (kept only for a value that never occurs),
# its g1 gather replaced by the lane byte; K4 scatter's x gather as a
# constant; the parent's K3 and K11 ("old_": patched copies of the
# --parent tree) with their global atomics as plain stores; this tree's
# K3 (and K11) with scalar atomics for the tile flush's vector
# reductions, and with vector reductions for the sole groups' stores. The
# name's prefix selects the rows that use it (ABLATION_ROWS)
ABLATIONS = {
    "old_k3_stores": ("warp_rows.cuh", [(
        "if (head && row >= 0 && v != 0.f) atomicAdd(yr + row, v);",
        "if (head && row >= 0 && v != 0.f) yr[row] = v;")]),
    "old_k11_stores": ("permc_spmv.cu", [(
        "if (t != 0.f) atomicAdd(yr + hi[s] * kLanes, t);",
        "if (t != 0.f) yr[hi[s] * kLanes] = t;")]),
    "red_scalar": ("router_spmv.cu", [(
        "      atomicAdd(y4 + i, t);",
        "      {\n        float* q = yr + 4 * i;\n"
        "        if (t.x != 0.f) atomicAdd(q, t.x);\n"
        "        if (t.y != 0.f) atomicAdd(q + 1, t.y);\n"
        "        if (t.z != 0.f) atomicAdd(q + 2, t.z);\n"
        "        if (t.w != 0.f) atomicAdd(q + 3, t.w);\n      }")]),
    "red_all": ("router_spmv.cu", [("if (sole)", "if (false && sole)")]),

    "k4_no_gather": ("planar_spmv.cu", [(
        "xv[k] = __ldg(x + col[k] + static_cast<int>(w[k] & mask));",
        "xv[k] = 1.0f;")]),
    "k1_no_atomics": ("router_spmv.cu", [(
        "if (v != 0.f) atomicAdd(y + row, v);", "if (v != 0.f) y[row] = v;")]),
    "k1_no_gather": ("router_spmv.cu", [(
        "return __ldg(x + col);", "return 1.0f;")]),
    "k8_no_store": ("tropical_spmv.cu", [(
        "if (dst[u] >= 0) out[dst[u]] = v[u];",
        "if (dst[u] >= 0 && v[u] == -7) out[dst[u]] = v[u];")]),
    "k8_no_gather": ("tropical_spmv.cu", [(
        "if (e < n) v[u] = __ldg(src + el.s * kLanes + __ldg(lane_of + e));",
        "if (e < n) v[u] = __ldg(lane_of + e);")]),
}


ABLATION_ROWS = {"k1_": ("planar", "router"), "k8_": ("tropical",),
                 "k4_": ("scatter",), "old": ("reduce",),
                 "red": ("reduce",)}


def ablation_tree(name: str, base: Path = ROOT):
    """The package of the tree at `base` (this tree's by default) copied
    under _archive_check/ablate_<name>/ with ABLATIONS[name] applied to its
    source, loaded as its own package."""
    root = ROOT / "_archive_check" / f"ablate_{name}"
    if root.exists():
        shutil.rmtree(root)
    pkg = root / "graphlily_tpu_torch"
    shutil.copytree(base / "graphlily_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    source, edits = ABLATIONS[name]
    src = pkg / "csrc" / source
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old!r} is not in the "
                               "source once")
        text = text.replace(old, new)
    src.write_text(text)
    return load_package(root, f"glt_ablate_{name}")


def log_registers(trees: dict) -> None:
    """Each tree's K1 kernels as ptxas built them (the build log of
    csrc/router_spmv.cu): registers, spills, and the blocks of 256 threads
    an SM holds by its 65,536 registers (allocated 256 a warp) and its
    2,048 threads."""
    import re
    for k, pkg in trees.items():
        b = pkg.ops._build
        log_file = b.library_path(b.CSRC_DIR / "router_spmv.cu").with_suffix(
            ".log")
        name = spill = None
        for line in log_file.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), None
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name and "router_fused" in name:
                regs = int(m.group(1))
                warp = -(-regs * 32 // 256) * 256
                try:
                    full = subprocess.run(["c++filt", name],
                                          capture_output=True, text=True,
                                          check=True).stdout
                    name = re.search(r"router_fused\w*<[^>]*>", full).group(0)
                except (OSError, subprocess.SubprocessError, AttributeError):
                    pass
                log(f"{k}: {name}: {regs} registers, {spill} bytes spilled, "
                    f"{min(8, 65536 // warp // 8)} blocks an SM by registers")


def time_ms(torch, fn, iters: int = 100, reps: int = 5) -> float:
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


def capture_layouts(scale: float, kernels, graphs) -> dict:
    """Pack every layout the A/B's `kernels` need on the `graphs` ("standin",
    "graph500") through the public apps, recording what the modules'
    packers return."""
    from graphlily_tpu_torch.module import spmv_module, spmspv_module
    got = []
    saved = {}
    for mod in (spmv_module, spmspv_module):
        for name in ("pack_csr_chunks", "pack_planar", "pack_router",
                     "pack_tropical"):
            fn = getattr(mod, name)
            saved[(mod, name)] = fn

            def rec(*a, _fn=fn, **kw):
                got.append(_fn(*a, **kw))
                return got[-1]
            setattr(mod, name, rec)
    out = {}
    try:
        if "standin" in graphs:
            out.update(standin_layouts(scale, kernels, got))
        if "graph500" in graphs:
            out.update(graph500_layouts(kernels, got))
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return out


def standin_layouts(scale: float, kernels, got: list) -> dict:
    """The googleplus and pokec stand-ins' layouts."""
    from graphlily_tpu_torch import EngineConfig, ArithmeticSemiring
    from graphlily_tpu_torch.apps import SSSP, PageRank, BFS
    from graphlily_tpu_torch.io import (iccad_standin, degree_sort_permutation,
                                        symmetric_permute,
                                        util_round_csr_matrix_dim)
    from graphlily_tpu_torch.module import SpMVModule
    out = {}
    engine = "auto" if scale >= 1 else "planar"
    t0 = time.perf_counter()
    g = iccad_standin("googleplus", scale=scale, seed=0)
    if "chunked" in kernels:
        sssp = SSSP(EngineConfig(sort_rows_by_degree=True, device="cuda"))
        sssp.load_and_format_matrix(g)
        out["sssp_row"], out["sssp_col"] = got[-2], got[-1]
        gs = symmetric_permute(g, degree_sort_permutation(g))
        util_round_csr_matrix_dim(gs, 1024, 1024)
        m = SpMVModule(EngineConfig(engine="pallas", device="cuda"))
        m.set_semiring(ArithmeticSemiring)
        m.load_and_format_matrix(gs)
        out["gp_muladd"] = got[-1]
    if {"router", "reduce"} & set(kernels):
        pr = PageRank(EngineConfig(
            sort_rows_by_degree=True,
            engine="auto" if scale >= 1 else "router"))
        pr.load_and_format_matrix(g, 0.9)
        if pr.SpMV_.engine_name != "roll":
            raise AssertionError(f"googleplus resolved "
                                 f"{pr.SpMV_.engine_name!r}, not roll")
        out["roll"] = got[-1]
        out["roll_csr"] = pr.SpMV_.csr_matrix_
    log(f"googleplus layouts: {time.perf_counter() - t0:.1f} s")
    if not {"planar", "tropical", "scatter", "tile", "walk",
            "reduce"} & set(kernels):
        return out
    p = iccad_standin("pokec", scale=scale, seed=0)
    if {"tropical", "scatter", "walk"} & set(kernels):
        t0 = time.perf_counter()
        sp = SSSP(EngineConfig(sort_rows_by_degree=True,
                               engine="auto" if scale >= 1 else "router"))
        sp.load_and_format_matrix(p)
        if sp.SpMV_.engine_name != "tropical":
            raise AssertionError(f"pokec SSSP resolved "
                                 f"{sp.SpMV_.engine_name!r}")
        out["tropical"] = got[-1]
        log(f"pokec tropical layout: {time.perf_counter() - t0:.1f} s")
    if not {"planar", "scatter", "tile", "reduce"} & set(kernels):
        return out
    t0 = time.perf_counter()
    pr = PageRank(EngineConfig(sort_rows_by_degree=True, engine=engine))
    pr.load_and_format_matrix(p, 0.9)
    out["free"], out["free_csr"] = got[-1], pr.SpMV_.csr_matrix_
    log(f"pokec free layout: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bfs = BFS(EngineConfig(sort_rows_by_degree=True, engine=engine,
                           planar_deal="permc"))
    bfs.load_and_format_matrix(p)
    out["permc"], out["permc_csr"] = got[-1], bfs.SpMV_.csr_matrix_
    log(f"pokec PERM-C layout: {time.perf_counter() - t0:.1f} s")
    if "scatter" in kernels:
        t0 = time.perf_counter()
        bfs = BFS(EngineConfig(sort_rows_by_degree=True, engine=engine,
                               planar_deal="bucket"))
        bfs.load_and_format_matrix(p)
        out["bucket"] = got[-1]
        log(f"pokec bucket layout: {time.perf_counter() - t0:.1f} s")
    return out


# The benchmark's Graph 500 graphs (bench_torch/configs), each formatted
# as its cell formats it: (configuration, app, layout key, the engine the
# ladder picks) by kernel set
GRAPH500 = {
    "router": ("graph500-s18", "PageRank", "g500_s18", "roll"),
    "planar": ("graph500-s19", "PageRank", "g500_s19", "planar"),
    "walk": ("graph500-s19-k3", "SSSP", "g500_s19_k3", "tropical"),
}


def graph500_layouts(kernels, got: list, seed: int = 1) -> dict:
    """The layouts of the benchmark's cells that run `kernels`' rows (K1 on
    scale 18, K4 fused on scale 19, the tropical walk on scale 19 with
    kernel 3's weights), from the cells' own graph generator and engine
    settings, drawn on the card from `seed`."""
    import torch
    from graphlily_tpu_torch import EngineConfig
    from graphlily_tpu_torch.apps import SSSP, PageRank
    from graphlily_tpu_torch.io.matrix import CSRMatrix
    sys.path.append(str(ROOT / "bench_torch"))
    import graph as bench_graph
    import spec
    out = {}
    for kernel, (name, app, key, engine) in GRAPH500.items():
        if kernel not in kernels:
            continue
        t0 = time.perf_counter()
        config = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        g = bench_graph.make(config, gen, torch.device("cuda"))
        n = g.num_vertices
        csr = CSRMatrix(n, n, g.weights.copy(), g.indices.copy(),
                        g.indptr.copy())
        cfg = EngineConfig(**config["engine"], device="cuda")
        if app == "PageRank":
            a = PageRank(cfg)
            a.load_and_format_matrix(csr, damping=0.9)
        else:
            a = SSSP(cfg)
            a.load_and_format_matrix(csr, unit_weights=False)
        if a.SpMV_.engine_name != engine:
            raise AssertionError(f"{name} resolved {a.SpMV_.engine_name!r}, "
                                 f"not {engine!r}")
        out[key], out[f"{key}_csr"] = got[-1], a.SpMV_.csr_matrix_
        log(f"{name} {app} layout ({a.SpMV_.engine_name}): "
            f"{time.perf_counter() - t0:.1f} s")
        del a, g, csr
    return out


def frontier(torch, ncols: int, kind: str, zero: float, rng):
    k = {"empty": 0, "one": 1, "5pct": ncols // 20}[kind]
    x = np.full(ncols, zero, np.float32)
    x[rng.choice(ncols, size=k, replace=False)] = rng.integers(
        1, 1001, k).astype(np.float32)
    return torch.from_numpy(x).to("cuda")


def same(torch, label: str, a, b, exact: bool) -> None:
    if exact:
        ok = torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        ok = float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    if not ok:
        raise AssertionError(f"{label}: old and new kernels disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--variant", type=Path, nargs="*", default=[],
                    help="more trees, timed in the same turns as --parent")
    ap.add_argument("--unchecked", action="store_true",
                    help="do not hold the variants' outputs to the new "
                         "tree's (ablations that compute another y)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--entries", type=int, nargs="*", default=[])
    ap.add_argument("--kernels", nargs="+", default=KERNELS, choices=KERNELS)
    ap.add_argument("--graphs", nargs="+", default=GRAPHS, choices=GRAPHS,
                    help="the stand-ins, the benchmark's Graph 500 graphs "
                         "(router, planar and walk rows), or both")
    ap.add_argument("--ablations", action="store_true",
                    help="add the ablation trees (ABLATIONS) to their rows")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    sys.path.insert(0, str(ROOT))
    new = load_package(ROOT, "graphlily_tpu_torch")
    others = {"old": load_package(args.parent.resolve(), "glt_parent")}
    for i, path in enumerate(args.variant):
        others[path.name] = load_package(path.resolve(), f"glt_variant{i}")
    trees = {**others, "new": new}
    ablated = ({name: ablation_tree(name, args.parent.resolve()
                                    if name.startswith("old_") else ROOT)
                for name in ABLATIONS
                if set(ABLATION_ROWS[name[:3]]) & set(args.kernels)}
               if args.ablations else {})
    for pkg in (*trees.values(), *ablated.values()):
        pkg.ops._build.library()
    log_registers(trees)
    lays = capture_layouts(args.scale, args.kernels, args.graphs)
    rng = np.random.default_rng(7)
    rows = []

    def engines(cls: str, lay, semiring: str) -> dict:
        """One engine of `cls` per tree, on the same layout."""
        return {k: getattr(pkg.ops, cls)(lay, getattr(pkg, semiring),
                                         pkg.EngineConfig(device="cuda"))
                for k, pkg in trees.items()}

    def ab(label, engs, call, exact, extra=None, more=None, unchecked=()):
        """Outputs compared with the new tree's, then timed in turns: the
        other trees, then `more` (name -> callable, timed in the same
        turns; checked unless named in `unchecked`), then the new tree
        twice, then the same in reverse."""
        fns = {k: (lambda e=e: call(e)) for k, e in engs.items()}
        fns.update(more or {})
        outs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        checked = [k for k in fns if k != "new" and k not in unchecked
                   and (k == "old" or not args.unchecked or k not in others)]
        for k in checked:
            same(torch, f"{label} ({k})", outs["new"], outs[k], exact)
        rest = [k for k in fns if k != "new"]
        ms = {k: [] for k in fns}
        for k in [*rest, "new", "new", *reversed(rest)]:
            ms[k].append(time_ms(torch, fns[k]))
        row = {"row": label, **{f"{k}_ms": v for k, v in ms.items()}}
        if extra is not None:
            row.update(extra(engs["new"]))
        log(f"{label}: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
            for k, v in ms.items()) + f" ({card})")
        rows.append(row)

    inf = float(new.FLOAT_INF)
    def chunked():
        """The chunked kernel: ADDMIN, MULADD, K7p."""
        x = rng.integers(0, 1000, lays["sssp_row"].num_cols).astype(np.float32)
        x[rng.random(len(x)) < 0.5] = inf
        xmin = torch.from_numpy(x).to("cuda")
        xmul = torch.from_numpy(np.random.default_rng(8).random(
            lays["gp_muladd"].num_cols).astype(np.float32)).to("cuda")
        blocks = lambda e: {"blocks": e.arrays.blocks.shape[0],
                            "max_segments": e.arrays.max_segments,
                            "device_MB": e.arrays.nbytes() / 1e6}
        for key, semiring, xt, label in (
                ("sssp_row", "TropicalSemiring", xmin,
                 "ADDMIN (googleplus SSSP)"),
                ("gp_muladd", "ArithmeticSemiring", xmul,
                 "MULADD (googleplus)")):
            engs = engines("ChunkedSpMV", lays[key], semiring)
            ab(f"chunked {label}", engs, lambda e: e.spmv(xt),
               semiring != "ArithmeticSemiring", blocks)
            eng = engs["new"]
            for entries in args.entries:
                keep = eng.arrays
                eng.arrays = new.ops.chunked.chunk_entries(
                    lays[key], eng.device, entries)
                ms = time_ms(torch, lambda: eng.spmv(xt))
                rows.append({"row": f"chunked {label} E={entries}",
                             "new_ms": [ms], **blocks(eng)})
                log(f"chunked {label} with {entries} entries a block: "
                    f"{ms:.4f} ms ({eng.arrays.blocks.shape[0]} blocks)")
                eng.arrays = keep
            del engs, eng
        engs = engines("ChunkedSpMV", lays["sssp_col"], "TropicalSemiring")
        for kind in ("empty", "one", "5pct"):
            xf = frontier(torch, lays["sssp_col"].num_cols, kind, inf, rng)
            act = engs["new"].tile_activity(xf)
            ab(f"K7p ADDMIN {kind}", engs,
               lambda e, xf=xf, act=act: e.spmv_predicated(xf, act), True)
        del engs

    def planar():
        """K4 fused, "free" and PERM-C: the parent's stream walk against
        this tree's row-sorted form through K1's kernel, beside torch.mv,
        the form cut into other column windows and block sizes, ANDOR with
        its value stream, and the ablations; K4p fused at three
        frontiers."""
        import copy
        form = lambda e: {"elements": e.entries.idx.numel(),
                          "segments": e.entries.deps.shape[0],
                          "blocks": e.entries.blocks.shape[0],
                          "max_segments": e.entries.max_segments,
                          "col_bits": e.entries.col_bits,
                          "device_MB": e.entries.nbytes() / 1e6,
                          "init_s": e.init_seconds}

        def variant(eng, **kw):
            """`eng` sharing its arrays, over another cut of its form (None
            where the cut leaves the row too few bits)."""
            v = copy.copy(eng)
            e = eng.entries
            try:
                v.use_entries(new.ops.router.router_entries(v, "row", **{
                    "col_bits": e.col_bits, "values": e.vals is not None,
                    **kw}))
            except ValueError as err:
                log(f"  form {kw}: {err}")
                return None
            log(f"  form {kw}: {form(v)}")
            return v

        for key, label, graph in (("free", "K4 fused", "pokec"),
                                  ("permc", "K4 fused PERM-C", "pokec"),
                                  ("g500_s19", "K4 fused", "graph500-s19")):
            if key not in lays:
                continue
            lay, csr = lays[key], lays[f"{key}_csr"]
            xt = torch.from_numpy(np.random.default_rng(9).random(
                lay.num_cols).astype(np.float32)).to("cuda")
            xbool = torch.from_numpy((np.random.default_rng(10).random(
                lay.num_cols) < 0.05).astype(np.float32)).to("cuda")
            nnz = csr.nnz
            mat = torch.sparse_csr_tensor(
                torch.from_numpy(csr.adj_indptr.astype(np.int64)),
                torch.from_numpy(csr.adj_indices[:nnz].astype(np.int64)),
                torch.from_numpy(csr.adj_data[:nnz].astype(np.float32)),
                size=(csr.num_rows, csr.num_cols)).to("cuda")
            for semiring, x, name in (
                    ("ArithmeticSemiring", xt, "MULADD"),
                    ("LogicalSemiring", xbool, "ANDOR")):
                engs = engines("PlanarSpMV", lay, semiring)
                eng = engs["new"]
                log(f"{label} {name} form: {form(eng)}")
                vs = {f"col_bits={b}": variant(eng, col_bits=b)
                      for b in (11, 12, 13, 15, 16, 18)}
                vs.update({f"E={n}": variant(eng, block_entries=n)
                           for n in (2048, 8192)})
                if name == "ANDOR":
                    vs["with values"] = variant(eng, values=True)
                for abl, pkg in ablated.items():
                    if abl.startswith("k1_"):
                        vs[abl] = pkg.ops.PlanarSpMV(
                            lay, getattr(pkg, semiring),
                            pkg.EngineConfig(device="cuda"))
                more = {k: (lambda v=v: v.fused_spmv(x))
                        for k, v in vs.items() if v is not None}
                if name == "MULADD":
                    more["torch.mv"] = lambda: torch.mv(
                        mat, x[:csr.num_cols])
                ab(f"{label} {name} ({graph})", engs,
                   lambda e: e.fused_spmv(x), name == "ANDOR", form, more,
                   unchecked=("torch.mv", *[k for k in vs
                                            if k.startswith("k1_")]))
                del engs, eng, vs, more
            engs = engines("PlanarSpMV", lay, "LogicalSemiring")
            for kind in ("empty", "one", "5pct"):
                xf = frontier(torch, lay.num_cols, kind, 0.0, rng)
                act = engs["new"].activity(xf)
                ab(f"K4p{label[2:]} ANDOR {kind} ({graph})", engs,
                   lambda e, xf=xf, act=act: e.fused_predicated(xf, act), True)
            del engs, mat

    def router():
        """K1 (MULADD, ANDOR) beside torch.mv, the row-ordered form, other
        block sizes and the ablations; K1p (ANDOR) at three frontiers."""
        for key, graph in (("roll", "googleplus"),
                           ("g500_s18", "graph500-s18")):
            if key in lays:
                router_rows(lays[key], lays[f"{key}_csr"], graph)

    def router_rows(lay, csr, graph):
        xmul = torch.from_numpy(np.random.default_rng(8).random(
            lay.num_cols).astype(np.float32)).to("cuda")
        xbool = torch.from_numpy((np.random.default_rng(9).random(
            lay.num_cols) < 0.05).astype(np.float32)).to("cuda")
        nnz = csr.nnz
        mat = torch.sparse_csr_tensor(
            torch.from_numpy(csr.adj_indptr.astype(np.int64)),
            torch.from_numpy(csr.adj_indices[:nnz].astype(np.int64)),
            torch.from_numpy(csr.adj_data[:nnz].astype(np.float32)),
            size=(csr.num_rows, csr.num_cols)).to("cuda")
        form = lambda e: {"elements": e.entries.vals.numel(),
                          "segments": e.entries.deps.shape[0],
                          "blocks": e.entries.blocks.shape[0],
                          "max_segments": e.entries.max_segments,
                          "device_MB": e.entries.nbytes() / 1e6,
                          "init_s": e.init_seconds}
        for semiring, xt, label in (
                ("ArithmeticSemiring", xmul, f"K1 MULADD ({graph})"),
                ("LogicalSemiring", xbool, f"K1 ANDOR ({graph})")):
            engs = engines("RouterSpMV", lay, semiring)
            eng = engs["new"]
            variants = {}
            for name, kw in (("deposit", {"order": "deposit"}),
                             ("E=2048", {"block_entries": 2048}),
                             ("E=8192", {"block_entries": 8192}),
                             *((f"col_bits={b}", {"col_bits": b})
                               for b in (12, 13, 14, 16))):
                v = new.ops.RouterSpMV(lay, getattr(new, semiring),
                                       new.EngineConfig(device="cuda"))
                try:
                    v.use_entries(new.ops.router.router_entries(v, **kw))
                except ValueError as err:   # a window too wide for the row
                    log(f"{label} {name}: {err}")
                    continue
                variants[name] = v
                log(f"{label} {name}: {form(v)}")
            for name, pkg in ablated.items():
                if not name.startswith("k1_"):
                    continue
                variants[name] = pkg.ops.RouterSpMV(
                    lay, getattr(pkg, semiring),
                    pkg.EngineConfig(device="cuda"))
            more = {k: (lambda v=v: v.fused_spmv(xt))
                    for k, v in variants.items()}
            if semiring == "ArithmeticSemiring":
                more["torch.mv"] = lambda: torch.mv(mat, xt[:csr.num_cols])
            ab(label, engs, lambda e: e.fused_spmv(xt),
               semiring != "ArithmeticSemiring", form, more,
               unchecked=("torch.mv", *ablated))
            del engs, eng, variants, more
        engs = engines("RouterSpMV", lay, "LogicalSemiring")
        for kind in ("empty", "one", "5pct"):
            xf = frontier(torch, lay.num_cols, kind, 0.0, rng)
            act = engs["new"].activity(xf)
            ab(f"K1p ANDOR {kind} ({graph})", engs,
               lambda e, xf=xf, act=act: e.fused_predicated(xf, act), True)
        del engs

    def tropical():
        """K8 on pokec SSSP's layout, beside K9 on triples derived from
        the same planes."""
        from graphlily_tpu_torch.io.tropical_format import (
            derive_split_triples)
        lay = lays["tropical"]
        t0 = time.perf_counter()
        xsort2, triples2 = derive_split_triples(lay.planar, dict(
            planes2=lay.planes2, rg2=lay.rg2, in_order=lay.in_order,
            kb=lay.kb))
        tri = dataclasses.replace(lay, xsort2=xsort2, triples2=triples2,
                                  planes2=np.zeros((0, 0, 8, 128), np.int8))
        log(f"K9 triples derived from the planes: "
            f"{time.perf_counter() - t0:.1f} s")
        engs = engines("TropicalSpMV", lay, "TropicalSemiring")
        k9 = new.ops.TropicalSpMV(tri, new.TropicalSemiring,
                                  new.EngineConfig(device="cuda"))
        x = rng.integers(0, 1000, lay.num_cols).astype(np.float32)
        x[rng.random(lay.num_cols) < 0.5] = inf
        g1 = engs["new"].scatter(torch.from_numpy(x).to("cuda"))
        eng = engs["new"]
        form = lambda e: {"pieces": e.arrays.split.pieces.shape[0],
                          "elements": e.arrays.split.lanes.numel(),
                          "device_MB": e.arrays.split.nbytes() / 1e6,
                          "planes_MB": lay.planes2.nbytes / 1e6,
                          "init_s": e.init_seconds,
                          "g2_MB": e.nchunks2 * 4096 / 1e6}
        log(f"K8 compact form: {form(eng)}")
        n2 = eng.nchunks2 * 1024
        more = {"K9 triples": lambda: k9.split(g1),
                "g2 fill": lambda: torch.zeros(n2, dtype=torch.int32,
                                               device="cuda")}
        k8_ablated = [name for name in ablated if name.startswith("k8_")]
        for name in k8_ablated:
            pkg = ablated[name]
            v = pkg.ops.TropicalSpMV(lay, pkg.TropicalSemiring,
                                     pkg.EngineConfig(device="cuda"))
            more[name] = lambda v=v: v.split(g1)
        ab("K8 split (pokec SSSP)", engs, lambda e: e.split(g1), True, form,
           more, unchecked=("g2 fill", *k8_ablated))
        del engs, k9, more

    def scatter():
        """K4 scatter on pokec's "free", "bucket" and PERM-C layouts and
        the tropical pass 1, beside the stream's zero fill alone, the
        kernel alone and the constant-x ablation; K4p scatter at three
        frontiers."""
        import copy

        def store_only(eng, x):
            """K4 scatter into one stream, allocated once: the kernel
            without the wrapper's allocation."""
            buf = torch.zeros(eng.nsteps * eng.f * 1024,
                              dtype=eng._stream_dtype, device="cuda")
            return lambda: eng._launch_store(x, None, buf)

        def filled(eng):
            """`eng` over its store form without tails: the stream zeroed
            whole by the wrapper first, as K4p scatter's is."""
            v = copy.copy(eng)
            v.store_entries = dataclasses.replace(eng.store_entries,
                                                  tails=None)
            return v

        form = lambda e: {"elements": e.store_entries.idx.numel(),
                          "pieces": e.store_entries.deps.shape[0],
                          "blocks": e.store_entries.blocks.shape[0],
                          "max_segments": e.store_entries.max_segments,
                          "device_MB": e.store_entries.nbytes() / 1e6,
                          "stream_MB": e.nsteps * e.f * 4096 / 1e6,
                          "init_s": e.init_seconds}
        xmul = lambda n: torch.from_numpy(np.random.default_rng(9).random(
            n).astype(np.float32)).to("cuda")
        xbool = lambda n: torch.from_numpy((np.random.default_rng(10).random(
            n) < 0.05).astype(np.float32)).to("cuda")

        def xmin(n):
            x = rng.integers(0, 1000, n).astype(np.float32)
            x[rng.random(n) < 0.5] = inf
            return torch.from_numpy(x).to("cuda")

        rows_ = [("free", "PlanarSpMV", "ArithmeticSemiring", xmul, "MULADD"),
                 ("free", "PlanarSpMV", "LogicalSemiring", xbool, "ANDOR"),
                 ("bucket", "PlanarSpMV", "ArithmeticSemiring", xmul,
                  "MULADD"),
                 ("permc", "PlanarSpMV", "ArithmeticSemiring", xmul,
                  "MULADD"),
                 ("tropical", "TropicalSpMV", "TropicalSemiring", xmin,
                  "ADDMIN")]
        for key, cls, semiring, make_x, name in rows_:
            engs = engines(cls, lays[key], semiring)
            pass1 = lambda e: e.planar if cls == "TropicalSpMV" else e
            eng = pass1(engs["new"])
            x = make_x(eng.num_cols)
            n = eng.nsteps * eng.f * 1024
            dtype = eng._stream_dtype
            log(f"K4 scatter {name} ({key}) store form: {form(eng)}")
            zf = filled(eng)
            more = {"fill alone": lambda n=n, dtype=dtype: torch.zeros(
                        n, dtype=dtype, device="cuda"),
                    "fill + kernel (no tails)": lambda: zf.scatter(x),
                    "kernel alone": store_only(eng, x)}
            for abl, pkg in ablated.items():
                if abl.startswith("k4_"):
                    v = getattr(pkg.ops, cls)(lays[key], getattr(pkg, semiring),
                                              pkg.EngineConfig(device="cuda"))
                    more[abl] = lambda v=v: v.scatter(x)
            ab(f"K4 scatter {name} (pokec {key})", engs,
               lambda e: e.scatter(x), True, lambda e: form(pass1(e)), more,
               unchecked=("fill alone",
                          *[k for k in more if k.startswith("k4_")]))
            if key in ("free", "tropical") and name != "MULADD":
                zero = eng.semiring.zero
                for kind in ("empty", "one", "5pct"):
                    xf = frontier(torch, eng.num_cols, kind, zero, rng)
                    act = (xf.reshape(-1, 1024) != zero).any(1).to(
                        torch.uint8)
                    ab(f"K4p scatter {name} {kind} (pokec {key})", engs,
                       lambda e, xf=xf, act=act: e.scatter_predicated(
                           xf, act), True)
            del engs, eng, more

    def tile():
        """K4p fused (ANDOR) on pokec "free" and PERM-C at three
        frontiers: the tile form against wider windows, the piece-ordered
        form and K4 fused's whole product, in the same turns."""
        import copy
        for key in ("free", "permc"):
            engs = engines("PlanarSpMV", lays[key], "LogicalSemiring")
            eng = engs["new"]
            e = eng.pred_entries
            log(f"K4p fused ({key}) tile form: elements {e.idx.numel()}, "
                f"segments {e.deps.shape[0]}, blocks {e.blocks.shape[0]}, "
                f"max_segments {e.max_segments}, "
                f"{e.nbytes() / 1e6:.1f} MB, init {eng.init_seconds:.2f} s")
            vs = {}
            for bits in (11, 12, 13):
                v = copy.copy(eng)
                f = new.ops.router.router_entries(
                    v, "row", col_bits=bits, values=e.vals is not None)
                f.deps[:, 3] = f.deps[:, 1] >> bits     # flag: the window
                v.pred_entries = f
                vs[f"window 2**{bits}"] = (v, bits)
                log(f"  window 2**{bits}: segments {f.deps.shape[0]}, "
                    f"max_segments {f.max_segments}")
            v = copy.copy(eng)
            v.use_entries(new.ops.router.router_entries(
                v, "deposit", values=e.vals is not None), pred=True)
            vs["piece order"] = (v, None)
            log(f"  piece order: segments {v.pred_entries.deps.shape[0]}, "
                f"max_segments {v.pred_entries.max_segments}")
            for kind in ("empty", "one", "5pct"):
                xf = frontier(torch, eng.num_cols, kind, 0.0, rng)
                act = eng.activity(xf)
                more = {}
                for name, (v, bits) in vs.items():
                    if bits is None:
                        more[name] = (lambda v=v, xf=xf, act=act:
                                      v.fused_predicated(xf, act))
                        continue
                    k = 1 << (bits - 10)
                    pad = -act.numel() % k
                    coarse = torch.cat([act, act.new_zeros(pad)]).view(
                        -1, k).amax(1).contiguous()
                    more[name] = (lambda v=v, xf=xf, c=coarse:
                                  v._launch_fused(xf, c,
                                                  "glt_router_fused_pred",
                                                  "fused_pred"))
                more["K4 fused (whole product)"] = (
                    lambda xf=xf: eng.fused_spmv(xf))
                ab(f"K4p fused ANDOR {kind} (pokec {key})", engs,
                   lambda e, xf=xf, act=act: e.fused_predicated(xf, act),
                   True, more=more)
            del engs, eng, vs

    def walk():
        """The tropical engine call on pokec SSSP's layout: the parent's
        three passes against this tree's walk, pull and at three
        frontiers; the walk's row form at 2**13-2**15 column windows; K10
        alone."""
        for key, graph in (("tropical", "pokec SSSP"),
                           ("g500_s19_k3", "graph500-s19 SSSP")):
            if key in lays:
                walk_rows(lays[key], graph)

    def walk_rows(lay, graph):
        import copy
        engs = engines("TropicalSpMV", lay, "TropicalSemiring")
        eng = engs["new"]
        p = eng.planar
        log(f"walk forms: row {p.entries.idx.numel()} elements, "
            f"{p.entries.deps.shape[0]} segments, col_bits "
            f"{p.entries.col_bits}, {p.entries.nbytes() / 1e6:.1f} MB; tile "
            f"{p.pred_entries.deps.shape[0]} segments, "
            f"{p.pred_entries.nbytes() / 1e6:.1f} MB; store "
            f"{p.store_entries.nbytes() / 1e6:.1f} MB; the three derived in "
            f"{p.init_seconds:.2f} s")
        x = rng.integers(0, 1000, lay.num_cols).astype(np.float32)
        x[rng.random(lay.num_cols) < 0.5] = inf
        xt = torch.from_numpy(x).to("cuda")
        more = {}
        for bits in (13, 14, 15):
            if bits == p.entries.col_bits:
                continue
            v = copy.copy(p)
            v.entries = new.ops.router.router_entries(v, "row",
                                                      col_bits=bits)
            log(f"  row form at 2**{bits} columns: "
                f"{v.entries.deps.shape[0]} segments, "
                f"{v.entries.nbytes() / 1e6:.1f} MB")
            more[f"window 2**{bits}"] = (
                lambda v=v: eng._finish(v.fused_spmv(xt), None, None))
        ab(f"tropical engine call ({graph}; new row form 2**"
           f"{p.entries.col_bits})", engs, lambda e: e(xt), True, more=more)
        del more
        for kind in ("empty", "one", "5pct"):
            xf = frontier(torch, lay.num_cols, kind, inf, rng)
            ab(f"tropical SpMSpV call {kind} ({graph})", engs,
               lambda e, xf=xf: e.call_predicated(xf), True)
        g2 = eng.split(eng.scatter(xt))
        ab(f"K10 window reduce ({graph}, unchanged)", engs,
           lambda e: e.window_reduce(g2), True)
        del engs, eng, p, g2

    def turns(label, fns, extra=None):
        """`fns` (name -> callable) timed in turns, forward then reversed,
        unchecked: the ablations of the parent's kernels."""
        ms = {k: [] for k in fns}
        for k in [*fns, *reversed(list(fns))]:
            ms[k].append(time_ms(torch, fns[k]))
        rows.append({"row": label, **{f"{k}_ms": v for k, v in ms.items()},
                     **(extra or {})})
        log(f"{label}: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
            for k, v in ms.items()) + f" ({card})")

    def reduce():
        """Phase C: K3 on the googleplus roll stream and pokec's "free"
        stream, K11 on pokec BFS's PERM-C layout (MULADD): the parent's
        kernels with their atomics as stores, old against new with the
        group sizes and flush variants, and the split engine call."""
        import copy
        red = new.ops.router.reduce_groups

        def facts(e):
            g = e.groups.groups
            t0 = time.perf_counter()
            red(e.arrays.c_code)
            torch.cuda.synchronize()
            return {"groups": g.shape[0], "sole_groups": int(g[:, 3].sum()),
                    "chunks": e.groups.order.numel(),
                    "region_rows": e.region_rows,
                    "regions": e.num_regions,
                    "table_MB": e.groups.nbytes() / 1e6,
                    "table_s": time.perf_counter() - t0}

        xmul = lambda n: torch.from_numpy(np.random.default_rng(9).random(
            n).astype(np.float32)).to("cuda")
        for key, cls, label, old_abl in (
                ("roll", "RouterSpMV", "K3 (googleplus roll)",
                 "old_k3_stores"),
                ("free", "PlanarSpMV", "K3 (pokec free)", "old_k3_stores"),
                ("permc", "PlanarSpMV", "K11 (pokec PERM-C)",
                 "old_k11_stores")):
            engs = engines(cls, lays[key], "ArithmeticSemiring")
            eng = engs["new"]
            x = xmul(eng.num_cols)
            stream = eng.scatter(x)
            log(f"{label} table: {facts(eng)}")
            if old_abl in ablated:
                pkg = ablated[old_abl]
                v = getattr(pkg.ops, cls)(lays[key], pkg.ArithmeticSemiring,
                                          pkg.EngineConfig(device="cuda"))
                turns(f"{label} old kernel, atomics as stores",
                      {"old": lambda: engs["old"].reduce(stream),
                       "old, stores": lambda v=v: v.reduce(stream)})
                del v
            more = {}
            for n in (4, 8, 16, 32, 64, 128):
                if n == new.ops.router.REDUCE_GROUP_CHUNKS:
                    continue
                v = copy.copy(eng)
                v.groups = red(eng.arrays.c_code, n)
                log(f"  groups of {n}: {v.groups.groups.shape[0]} groups, "
                    f"{int(v.groups.groups[:, 3].sum())} sole")
                more[f"groups of {n}"] = lambda v=v: v.reduce(stream)
            for abl, pkg in ablated.items():
                if abl.startswith("red_"):
                    v = getattr(pkg.ops, cls)(lays[key],
                                              pkg.ArithmeticSemiring,
                                              pkg.EngineConfig(device="cuda"))
                    more[abl] = lambda v=v: v.reduce(stream)
            ab(label, engs, lambda e: e.reduce(stream), False, facts, more)
            ab(f"split engine call, scatter -> {label}", engs,
               lambda e: e.reduce(e.scatter(x)), False)
            del engs, eng, more, stream

    for name in args.kernels:
        {"chunked": chunked, "planar": planar, "router": router,
         "tropical": tropical, "scatter": scatter, "tile": tile,
         "walk": walk, "reduce": reduce}[name]()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_kernels.json").write_text(json.dumps(
        {"card": card, "scale": args.scale, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
