"""Build and bind the port's CUDA kernels.

`nvcc` compiles every `.cu` file under `graphlily_tpu_torch/csrc/` for
sm_90a into one shared library with a plain C interface, and `ctypes`
loads it. The build runs at first use, into `graphlily_tpu_torch/build/`
(git-ignored), under a name keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once. Nothing here
runs at import: on a machine without CUDA the module imports and only
`library()` fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of csrc/router_spmv.cu: pointers and the CUDA stream as
# c_void_p, sizes and flags as c_int; each returns cudaGetLastError().
SIGNATURES = {
    "glt_router_scatter": [_P] * 8 + [_I] * 5 + [_P],
    "glt_router_reduce": [_P] * 5 + [_I] * 2 + [_P],
    "glt_router_fused": [_P] * 11 + [_I] * 6 + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels build only where the CUDA toolkit "
                       "is installed")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libglt_kernels_{h.hexdigest()[:16]}.so"


def build(out: Path) -> str:
    """Compile the sources into `out`; returns nvcc's output (the ptxas
    register and spill report). The library is written under a temporary
    name and renamed, so a concurrent or cut-off build never leaves a
    partial file under the final name."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
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
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
