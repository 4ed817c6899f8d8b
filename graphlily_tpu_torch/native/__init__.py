"""The port's native host code: the PERM-C greedy in C++.

`permc_greedy.cpp` is the port's copy of the JAX package's
`native/permc_greedy.cpp`. g++ (or `$CXX`) builds it at first use into
`graphlily_tpu_torch/build/` (git-ignored) under a name keyed by a hash of
the source and the flags, and ctypes loads it. The flags are the JAX
package's (its `native/Makefile`) without `-fopenmp` and
`-D_GLIBCXX_PARALLEL`: the greedy is one sequential loop, and the card
machine's g++ has no OpenMP runtime. A failed build or load raises:
nothing falls back to numpy quietly (`pack_permc(native=False)` picks
numpy by name).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "permc_greedy.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpermc_greedy_{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """Compile the source into `out`, under a temporary name renamed at
    the end, so a concurrent or cut-off build never leaves a partial file
    under the final name. Raises with g++'s output if it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                               f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built first if its hashed name is missing."""
    out = library_path()
    if not out.exists():
        build(out)
    lib = ctypes.CDLL(str(out))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.glt_permc_greedy.restype = i64
    lib.glt_permc_greedy.argtypes = [p] * 6 + [i64] * 4 + [p, i64, i64] \
        + [p] * 10
    return lib


def permc_greedy(tile, rho, sig, row, region, lo, ntiles, nregions, depth,
                 chunk_of=None, nca_in=0, spill_cb=8):
    """io/permc_format._greedy_permc_py in C++: the same arguments and the
    same tuple, bit for bit."""
    lib = library()
    n = len(tile)
    tile, rho, sig, row, region, lo = (
        np.ascontiguousarray(a, np.int64)
        for a in (tile, rho, sig, row, region, lo))
    chunks = (np.ascontiguousarray(chunk_of, np.int64)
              if chunk_of is not None else None)
    if any(len(a) != n for a in (rho, sig, row, region, lo,
                                 *([] if chunks is None else [chunks]))):
        raise ValueError("permc_greedy: the per-element arrays differ in "
                         "length")
    a_chunk, sub_of, cyc_of, pos_of = (np.empty(n, np.int64)
                                       for _ in range(4))
    # event bounds: at most one flush per element, depth drains a region
    fl_chunk, fl_region, fl_cycle = (np.empty(n + 1, np.int64)
                                     for _ in range(3))
    dr_region, dr_cycle = (np.empty(nregions * depth + 1, np.int64)
                           for _ in range(2))
    counts = np.zeros(3, np.int64)   # nca, flushes, drains
    ok = lib.glt_permc_greedy(
        tile.ctypes.data, rho.ctypes.data, sig.ctypes.data, row.ctypes.data,
        region.ctypes.data, lo.ctypes.data, n, ntiles, nregions, depth,
        None if chunks is None else chunks.ctypes.data, nca_in, spill_cb,
        a_chunk.ctypes.data, sub_of.ctypes.data, cyc_of.ctypes.data,
        pos_of.ctypes.data, fl_chunk.ctypes.data, fl_region.ctypes.data,
        fl_cycle.ctypes.data, dr_region.ctypes.data, dr_cycle.ctypes.data,
        counts.ctypes.data)
    if not ok:
        raise RuntimeError("permc spill recursion exceeded 64 rounds")
    nca, nf, ndr = (int(v) for v in counts)
    return (a_chunk, sub_of, cyc_of, pos_of, max(nca, 1),
            fl_chunk[:nf], fl_region[:nf], fl_cycle[:nf],
            dr_region[:ndr], dr_cycle[:ndr])
