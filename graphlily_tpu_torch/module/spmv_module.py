"""SpMV module.

Counterpart of `graphlily_tpu/module/spmv_module.py`: owns the formatted
matrix, the vector/mask/results buffers, a `run()` that executes one
masked semiring SpMV on the module's device, and a float64 CPU oracle.

Engine selection keeps the JAX package's ladder, and every engine it
names is ported: the chunked engine (ops/chunked.py, packed with the
semiring zero as pad value), the roll router (ops/router.py), the planar
router (ops/planar.py, packed with `config.planar_deal`), the tropical
engine (ops/tropical.py, SSSP where the chunked layout is infeasible) and
the reference COO engine ("xla", ops/reference.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import MaskType, OpType, FLOAT_INF
from ..io.matrix import CSRMatrix
from ..io.formatter import (util_round_csr_matrix_dim,
                            estimate_chunk_layout_gb, pack_csr_chunks)
from ..io.router_format import choose_region_rows, pack_router
from ..io.planar_format import pack_planar
from ..io.tropical_format import pack_tropical_pass1
from ..ops.reference import coo_from_csr, spmv_coo, ewise_add_scalar
from ..ops.chunked import ChunkedSpMV
from ..ops.router import RouterSpMV
from ..ops.planar import PlanarSpMV
from ..ops.tropical import TropicalSpMV
from ..utils.profiling import span
from .base import BaseModule, DeviceBuffer


# The chunked layout's limits, which both modules' ladders apply
CHUNKED_MAX_ROWS = 700_000
CHUNKED_MAX_GB = 2.0


def chunked_feasible(csr: CSRMatrix) -> bool:
    """Whether the chunked layout serves `csr`: at most CHUNKED_MAX_ROWS
    rows and CHUNKED_MAX_GB by `estimate_chunk_layout_gb`."""
    return (csr.num_rows <= CHUNKED_MAX_ROWS
            and estimate_chunk_layout_gb(csr) <= CHUNKED_MAX_GB)


def build_engine(name: str, csr: CSRMatrix, semiring, config: EngineConfig,
                 mask_type: MaskType, chunk_order: str = "row"):
    """The engine `name` ("chunked", "roll", "planar" or "tropical") over
    `csr`, packed for it; None for "xla", whose COO form each module
    builds. The chunked layout is in `chunk_order`: "row" for SpMV, "col"
    for SpMSpV."""
    if name == "chunked":
        return ChunkedSpMV(pack_csr_chunks(csr, pad_val=float(semiring.zero),
                                           chunk_order=chunk_order),
                           semiring, config, mask_type)
    if name == "roll":
        return RouterSpMV(pack_router(csr), semiring, config, mask_type)
    if name == "planar":
        return PlanarSpMV(pack_planar(csr, deal=config.planar_deal),
                          semiring, config, mask_type)
    if name == "tropical":
        return TropicalSpMV(pack_tropical_pass1(csr, config), semiring,
                            config, mask_type)
    return None


def resolve_router_flavor(csr) -> str:
    """Roll router while (page x region) runs stay long (epg >= 200),
    planar router on hypersparse graphs; same rule as the JAX package."""
    nrows = ((csr.num_rows + 1023) // 1024) * 1024
    ncols = ((csr.num_cols + 1023) // 1024) * 1024
    r = choose_region_rows(nrows, ncols, csr.nnz)
    epg = csr.nnz * r / max((ncols // 128) * nrows, 1)
    return "roll" if epg >= 200 else "planar"


def resolve_engine(csr: CSRMatrix, engine: str, tropical: bool) -> str:
    """The JAX package's engine ladder: "roll", "planar", "chunked",
    "tropical" or "xla"."""
    if engine == "router" and tropical:
        return "tropical"
    if engine == "pallas":
        return "chunked"
    if engine == "auto":
        if (tropical or csr.nnz < 2_000_000) and chunked_feasible(csr):
            return "chunked"
        if tropical:
            return "tropical"
        engine = "router"
    if engine == "router":
        return resolve_router_flavor(csr)
    if engine in ("roll", "planar", "xla"):   # a router flavor by name
        return engine
    raise ValueError(f"unknown engine {engine!r}")


class SpMVModule(BaseModule):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.csr_matrix_: Optional[CSRMatrix] = None
        self.vector_buf = DeviceBuffer()
        self.mask_buf = DeviceBuffer()
        self.results_buf = DeviceBuffer()
        # RouterSpMV, its PlanarSpMV, ChunkedSpMV or TropicalSpMV; None
        # for "xla"
        self.engine: Optional[RouterSpMV | ChunkedSpMV | TropicalSpMV] = None
        self.engine_name = ""
        self._coo = None
        self.num_rows_ = 0
        self.num_cols_ = 0
        self.set_offset(None)
        # False: `apply` returns the engine's output as its kernels left it,
        # without the ANDOR clamp and the mask, which the caller applies
        # (BFS's level step on the card); router and chunked engines only
        self.epilogue = True

    # ---- matrix ----------------------------------------------------------
    def load_and_format_matrix(self, csr_matrix: CSRMatrix,
                               skip_empty_rows: bool | None = None) -> None:
        """Format for the engine the ladder picks. `skip_empty_rows` is
        accepted for parity (empty rows cost nothing in these layouts)."""
        del skip_empty_rows
        assert self.semiring_ is not None, "set_semiring before formatting"
        self.csr_matrix_ = csr_matrix.copy()
        self.engine, self._coo = None, None
        self.set_offset(None)
        name = resolve_engine(csr_matrix, self.config.resolve_engine(),
                              self.semiring_.op == OpType.ADDMIN)
        self.engine_name = name
        self.engine = build_engine(name, csr_matrix, self.semiring_,
                                   self.config, self.mask_type_)
        if self.engine is not None:
            self.num_rows_ = self.engine.num_rows
            self.num_cols_ = self.engine.num_cols
        else:
            work = csr_matrix.copy()
            util_round_csr_matrix_dim(work, 1024, 1024)
            self._coo = coo_from_csr(work, dtype=self.config.torch_dtype,
                                     device=self.device)
            self.num_rows_, self.num_cols_ = work.num_rows, work.num_cols

    def send_matrix_host_to_device(self) -> None:
        """Parity no-op: formatting already moved the matrix."""
        return None

    def get_num_rows(self) -> int:
        return self.num_rows_

    def get_num_cols(self) -> int:
        return self.num_cols_

    def get_nnz(self) -> int:
        return self.csr_matrix_.nnz if self.csr_matrix_ is not None else 0

    # ---- vectors ---------------------------------------------------------
    def send_vector_host_to_device(self, vector) -> None:
        assert len(vector) <= self.num_cols_
        v = np.asarray(vector, dtype=self.config.dtype)
        if len(v) < self.num_cols_:
            fill = np.full(self.num_cols_ - len(v),
                           self.semiring_.zero if self.semiring_ else 0,
                           v.dtype)
            v = np.concatenate([v, fill])
        self.vector_buf.value = self._to_device(v)

    def send_mask_host_to_device(self, mask) -> None:
        v = np.asarray(mask, dtype=self.config.dtype)
        if len(v) < self.num_rows_:
            v = np.concatenate([v, np.zeros(self.num_rows_ - len(v), v.dtype)])
        self.mask_buf.value = self._to_device(v)

    def send_vector_device_to_host(self) -> np.ndarray:
        return self.vector_buf.value.cpu().numpy()

    def send_mask_device_to_host(self) -> np.ndarray:
        return self.mask_buf.value.cpu().numpy()

    def send_results_device_to_host(self) -> np.ndarray:
        return self.results_buf.value.cpu().numpy()

    def bind_vector_buf(self, buf: DeviceBuffer) -> None:
        self.vector_buf = buf

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    # ---- execution -------------------------------------------------------
    def set_offset(self, offset: float | None, calls: int = 1) -> None:
        """`apply` adds `offset`, a float already rounded to the config's
        dtype, to each result from now on; None stops that.

        On an engine whose fused walk adds into a set-up output
        (`walks_into`: K1 and K4 fused in MULADD), each of the next `calls`
        unmasked applies is one launch: it adds into the output that the
        apply before set up to `offset` (the first sets up its own), and
        sets up the next apply's in the same launch, all but the last. The
        outputs rotate through three buffers that this call allocates
        (torch.empty: no launch), so a result keeps its value until the
        apply after next, and the last one for good: a loop that feeds each
        result to the next apply (PageRank's pull) loses nothing. Every
        other engine, branch or apply adds the offset after the SpMV."""
        self.offset_ = offset
        self._outputs, self._turn, self._calls = None, 0, calls
        eng = self.engine
        if offset is not None and getattr(eng, "walks_into", False):
            self._outputs = torch.empty(
                (3, eng.out_len), dtype=self.config.torch_dtype,
                device=self.device).unbind(0)

    def apply(self, x: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """Functional core: y = mask(A (x) x), plus the offset where
        `set_offset` gave one, in the span `module.spmv`."""
        with span("module.spmv"):
            if self.offset_ is None:
                return self._spmv(x, mask)
            i = self._turn
            self._turn += 1
            if (self._outputs is None or i >= self._calls
                    or (mask is not None
                        and self.mask_type_ != MaskType.NO_MASK)):
                return ewise_add_scalar(self._spmv(x, mask), self.offset_)
            # iteration i reads x, adds into the output iteration i - 1 set
            # up and sets up the one iteration i + 1 adds into
            out = self._outputs[(i - 1) % 3]
            if i == 0:
                out.fill_(self.offset_)
            then = self._outputs[i % 3] if i + 1 < self._calls else None
            return self.engine(x, out=out, then=then, value=self.offset_)

    def _spmv(self, x: torch.Tensor,
              mask: torch.Tensor | None) -> torch.Tensor:
        if self.engine is not None:
            return self.engine(x, mask, self.mask_type_,
                               epilogue=self.epilogue)
        return spmv_coo(self._coo, x, self.semiring_, mask, self.mask_type_)

    def run(self) -> None:
        mask = (self.mask_buf.value if self.mask_type_ != MaskType.NO_MASK
                else None)
        self.results_buf.value = self.apply(self.vector_buf.value, mask)

    # ---- CPU oracle ------------------------------------------------------
    def compute_reference_results(self, vector, mask=None) -> np.ndarray:
        """Float64 CPU oracle of one masked SpMV."""
        csr = self.csr_matrix_
        nnz = csr.nnz
        rows = csr.row_ids()
        cols = csr.adj_indices[:nnz].astype(np.int64)
        vals = csr.adj_data[:nnz].astype(np.float64)
        x = np.asarray(vector, np.float64)
        n = self.num_rows_
        contrib_x = x[cols]
        if self.semiring_.op == OpType.MULADD:
            y = np.bincount(rows, weights=vals * contrib_x, minlength=n)
        elif self.semiring_.op == OpType.ANDOR:
            c = np.logical_and(vals != 0, contrib_x != 0).astype(np.float64)
            y = (np.bincount(rows, weights=c, minlength=n) != 0).astype(
                np.float64)
        else:
            # a min over each nonempty row's CSR segment
            y = np.full(n, self.semiring_.zero, np.float64)
            c = np.minimum(vals + contrib_x, float(FLOAT_INF))
            ptr = csr.adj_indptr[:csr.num_rows + 1].astype(np.int64)
            full = np.nonzero(np.diff(ptr))[0]
            if len(full):
                y[full] = np.minimum.reduceat(c, ptr[full])
        if mask is not None and self.mask_type_ != MaskType.NO_MASK:
            m = np.asarray(mask)
            if self.mask_type_ == MaskType.WRITE_TO_ZERO:
                y[m[:n] != 0] = 0
            else:
                y[m[:n] == 0] = 0
        return y
