"""Build and bind the port's CUDA kernels.

`nvcc` compiles each `.cu` file under `graphlily_tpu_torch/csrc/` for
sm_90a into its own shared library with a plain C interface, all files at
once (one nvcc process each), and `ctypes` loads them. The build runs at
first use, into `graphlily_tpu_torch/build/` (git-ignored), under names
keyed by a hash of the source, the shared headers (`*.cuh`) and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs at import: on a machine without CUDA the module imports
and only `library()` fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of csrc/*.cu: pointers and the CUDA stream as c_void_p,
# sizes and flags as c_int, scalars as c_float; each returns
# cudaGetLastError().
SIGNATURES = {
    # chunked_spmv.cu: K6 and K7 in one kernel; K7p
    "glt_chunked_spmv": [_P] * 9 + [_I] * 3 + [_F, _P],
    "glt_chunked_spmv_predicated": [_P] * 10 + [_I] * 3 + [_F, _P],
    # router_spmv.cu: K1 (also K4 fused), K2, K3 (over the region-group
    # table; also K11) and K1p (also K4p fused), K2p, K3p
    "glt_router_scatter": [_P] * 8 + [_I] * 5 + [_P],
    "glt_router_scatter_pred": [_P] * 9 + [_I] * 5 + [_P],
    "glt_router_reduce": [_P] * 6 + [_I] * 2 + [_P],
    "glt_router_reduce_pred": [_P] * 6 + [_I] * 2 + [_P],
    "glt_router_fused": [_P] * 6 + [_I] * 4 + [_P],
    "glt_router_fused_pred": [_P] * 7 + [_I] * 4 + [_P],
    # planar_spmv.cu: K4 scatter and K4p scatter over the store form, K5
    # (K4 scatter's last int is the semiring op: 2 is the tropical ADDMIN)
    "glt_planar_scatter": [_P] * 7 + [_I] * 5 + [_P],
    "glt_planar_scatter_pred": [_P] * 7 + [_I] * 4 + [_P],
    "glt_planar_xperm": [_P] * 3 + [_I] + [_P],
    # permc_spmv.cu: K11p (PERM-C run-sum reduce, predicated; K11 is K3's
    # kernel over the position-keyed rows)
    "glt_permc_reduce_pred": [_P] * 7 + [_I] * 2 + [_P],
    # tropical_spmv.cu: K8 (split, planes), K9 (split, triples), K10
    "glt_tropical_split": [_P] * 5 + [_I] + [_P],
    "glt_tropical_split_triples": [_P] * 7 + [_I] * 4 + [_P],
    "glt_tropical_window_reduce": [_P] * 5 + [_I] + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels build only where the CUDA toolkit "
                       "is installed")


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *headers()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def library_paths() -> list[Path]:
    return [library_path(src) for src in sources()]


def build(src: Path, out: Path) -> str:
    """Compile one source into `out`; returns nvcc's output (the ptxas
    register and spill report). The library is written under a temporary
    name and renamed, so a concurrent or cut-off build never leaves a
    partial file under the final name."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    out.with_suffix(".log").write_text(log)
    return log


@functools.cache
def library() -> types.SimpleNamespace:
    """Every C entry point of SIGNATURES, bound; the sources that changed
    are built first, each by its own nvcc, all at the same time."""
    paths = [(src, library_path(src)) for src in sources()]
    todo = [(src, out) for src, out in paths if not out.exists()]
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for fut in [pool.submit(build, src, out) for src, out in todo]:
                fut.result()
    libs = [ctypes.CDLL(str(out)) for _, out in paths]
    fns = {}
    for name, argtypes in SIGNATURES.items():
        lib = next((lib for lib in libs if hasattr(lib, name)), None)
        if lib is None:
            raise RuntimeError(f"no kernel library exports {name}")
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    # the CDLL handles stay referenced so the libraries stay loaded
    return types.SimpleNamespace(libraries=libs, **fns)
