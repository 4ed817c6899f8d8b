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
from ..io.tropical_format import pack_tropical
from ..ops.reference import coo_from_csr, spmv_coo
from ..ops.chunked import ChunkedSpMV
from ..ops.router import RouterSpMV
from ..ops.planar import PlanarSpMV
from ..ops.tropical import TropicalSpMV
from .base import BaseModule, DeviceBuffer


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
        if tropical or csr.nnz < 2_000_000:
            feasible = (csr.num_rows <= 700_000
                        and estimate_chunk_layout_gb(csr) <= 2.0)
            if feasible:
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

    # ---- matrix ----------------------------------------------------------
    def load_and_format_matrix(self, csr_matrix: CSRMatrix,
                               skip_empty_rows: bool | None = None) -> None:
        """Format for the engine the ladder picks. `skip_empty_rows` is
        accepted for parity (empty rows cost nothing in these layouts)."""
        del skip_empty_rows
        assert self.semiring_ is not None, "set_semiring before formatting"
        self.csr_matrix_ = csr_matrix.copy()
        self.engine, self._coo = None, None
        name = resolve_engine(csr_matrix, self.config.resolve_engine(),
                              self.semiring_.op == OpType.ADDMIN)
        self.engine_name = name
        if name == "chunked":
            self.engine = ChunkedSpMV(
                pack_csr_chunks(csr_matrix, pad_val=float(self.semiring_.zero)),
                self.semiring_, self.config, self.mask_type_)
        elif name == "roll":
            self.engine = RouterSpMV(pack_router(csr_matrix), self.semiring_,
                                     self.config, self.mask_type_)
        elif name == "planar":
            self.engine = PlanarSpMV(
                pack_planar(csr_matrix, deal=self.config.planar_deal),
                self.semiring_, self.config, self.mask_type_)
        elif name == "tropical":
            self.engine = TropicalSpMV(
                pack_tropical(csr_matrix, self.config), self.semiring_,
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
    def apply(self, x: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """Functional core: y = mask(A (x) x)."""
        if self.engine is not None:
            return self.engine(x, mask, self.mask_type_)
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
