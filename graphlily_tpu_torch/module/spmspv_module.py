"""SpMSpV module.

Counterpart of `graphlily_tpu/module/spmspv_module.py`: a CSC-formatted
matrix, a sparse frontier in and out (`SparseVector`, with its nnz a
device scalar), a dense mask, and a masked semiring SpMSpV.

The engine ladder is JAX's (`load_and_format_matrix`). On the engines the
frontier is dense (inactive = the semiring zero) and the product runs
their frontier-predicated kernels, so its work follows the frontier's
footprint: K7p over the chunks of active column tiles (chunked engine,
chunk_order="col" layout), K1p/K2p -> K3p over the live
deposits of active pages (roll router), K4p -> K3p over the pieces of
active tiles (planar router), the predicated walk over the elements of
active tiles (tropical engine, `TropicalSpMV.call_predicated`: K4p fused
ADDMIN, K1p's kernel; a tile is active where some x differs from
FLOAT_INF). The COO engine ("xla") compacts the frontier and
runs `spmspv_coo`. JAX's `simulate_ufixed` branch (the reference's
fixed-point value type) waits for ROADMAP queue 1, item 10: the port's
`EngineConfig` has no such field.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import MaskType, OpType, FLOAT_INF, apply_mask_sparse_style
from ..io.matrix import CSCMatrix, csc2csr
from ..ops.reference import coo_from_csc, spmspv_coo
from ..ops.vector import (SparseVector, sparse_from_entries, sparse_to_dense,
                          dense_to_sparse)
from ..ops.chunked import ChunkedSpMV
from ..ops.router import RouterSpMV
from ..ops.tropical import TropicalSpMV
from ..utils.profiling import span
from .base import BaseModule, DeviceBuffer
from .spmv_module import build_engine, chunked_feasible, resolve_router_flavor


class SpMSpVModule(BaseModule):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG,
                 out_buf_len: int | None = None):
        super().__init__(config)
        del out_buf_len   # accepted for parity with the reference's ctor
        self.csc_matrix_: Optional[CSCMatrix] = None
        self.vector_buf = DeviceBuffer()   # SparseVector
        self.mask_buf = DeviceBuffer()     # dense
        self.results_buf = DeviceBuffer()  # SparseVector
        # ChunkedSpMV (col layout), RouterSpMV, PlanarSpMV or TropicalSpMV;
        # None for "xla"
        self.engine: Optional[RouterSpMV | ChunkedSpMV | TropicalSpMV] = None
        self.engine_name = ""
        self._coo = None
        self.num_rows_ = 0
        self.num_cols_ = 0
        # False: `apply_dense` returns the engine's output as its kernels
        # left it, without the ANDOR clamp and the mask, which the caller
        # applies (BFS's level step on the card); router and chunked
        # engines only
        self.epilogue = True

    # ---- matrix ----------------------------------------------------------
    def load_and_format_matrix(self, csc_matrix: CSCMatrix,
                               reuse_from=None) -> None:
        """Format for the engine JAX's ladder picks. `reuse_from`: an
        SpMVModule formatted with the matrix this CSC is the twin of; its
        roll, planar or tropical engine is shared, not packed again (the
        twin's layout would be identical). The chunked engine is not
        shared: SpMSpV needs the chunk_order="col" layout."""
        assert self.semiring_ is not None, "set_semiring before formatting"
        self.csc_matrix_ = CSCMatrix(csc_matrix.num_rows, csc_matrix.num_cols,
                                     csc_matrix.adj_data.copy(),
                                     csc_matrix.adj_indices.copy(),
                                     csc_matrix.adj_indptr.copy())
        self.num_rows_ = csc_matrix.num_rows
        self.num_cols_ = csc_matrix.num_cols
        self.engine, self.engine_name, self._coo = None, "", None
        if reuse_from is not None and isinstance(
                reuse_from.engine, (RouterSpMV, TropicalSpMV)):
            self.engine = reuse_from.engine   # PlanarSpMV is a RouterSpMV
            self.engine_name = reuse_from.engine_name
            return
        engine = self.config.resolve_engine()
        if (engine in ("pallas", "auto", "router")
                and csc_matrix.num_rows % 1024 == 0
                and csc_matrix.num_cols % 1024 == 0):
            csr_twin = csc2csr(csc_matrix)
            if engine == "pallas" or chunked_feasible(csr_twin):
                self.engine_name = "chunked"
            elif self.semiring_.op == OpType.ADDMIN:
                self.engine_name = "tropical"
            else:
                self.engine_name = resolve_router_flavor(csr_twin)
            self.engine = build_engine(
                self.engine_name, csr_twin, self.semiring_, self.config,
                MaskType.NO_MASK, chunk_order="col")
        else:
            self.engine_name = "xla"
            self._coo = coo_from_csc(csc_matrix, dtype=self.config.torch_dtype,
                                     device=self.device)

    def send_matrix_host_to_device(self) -> None:
        """Parity no-op: formatting already moved the matrix."""
        return None

    def get_num_rows(self) -> int:
        return self.num_rows_

    def get_num_cols(self) -> int:
        return self.num_cols_

    def get_nnz(self) -> int:
        return self.csc_matrix_.nnz if self.csc_matrix_ is not None else 0

    @property
    def capacity(self) -> int:
        return self.config.frontier_capacity or self.num_rows_

    # ---- vectors ---------------------------------------------------------
    def send_vector_host_to_device(self, sv) -> None:
        """Accepts a SparseVector or an (indices, values) host pair."""
        if isinstance(sv, SparseVector):
            self.vector_buf.value = sv
        else:
            idx, vals = sv
            self.vector_buf.value = sparse_from_entries(
                idx, vals, self.capacity, dtype=self.config.torch_dtype,
                device=self.device)

    def send_mask_host_to_device(self, mask) -> None:
        self.mask_buf.value = self._to_device(mask)

    def send_mask_device_to_host(self) -> np.ndarray:
        return self.mask_buf.value.cpu().numpy()

    def send_results_device_to_host(self) -> SparseVector:
        return self.results_buf.value

    def get_results_nnz(self) -> int:
        """The reference's 4-byte readback of the results' nnz: the one
        host sync of a push step."""
        return int(self.results_buf.value.nnz)

    def bind_vector_buf(self, buf: DeviceBuffer) -> None:
        self.vector_buf = buf

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    # ---- execution -------------------------------------------------------
    def _run_engine(self, x: torch.Tensor,
                    epilogue: bool = True) -> torch.Tensor:
        """A (x) x through the engine's predicated kernels; x is padded
        with the semiring zero to the engine's column space. Without
        `epilogue`, as the kernels left it (no ANDOR clamp); `apply`, the
        reference call sequence's, always clamps."""
        ncp = self.engine.num_cols
        if x.shape[0] < ncp:
            x = torch.cat([x, x.new_full((ncp - x.shape[0],),
                                         self.semiring_.zero)])
        return self.engine.call_predicated(x, None, MaskType.NO_MASK,
                                           epilogue=epilogue)

    def apply_dense(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """Dense-frontier SpMSpV for app loops: x and y dense (inactive =
        the semiring zero). Returns y alone (JAX's also returns its nnz):
        the apps count the new frontier where they need it. In the span
        `module.spmspv`. Without `epilogue`, y unclamped and unmasked."""
        zero = self.semiring_.zero
        with span("module.spmspv"):
            if self.engine is not None:
                y = self._run_engine(x, self.epilogue)
                if not self.epilogue:
                    return y
            else:
                sv = dense_to_sparse(x, zero, self.capacity)
                _, y = spmspv_coo(self._coo, sv, self.semiring_, None,
                                  MaskType.NO_MASK, capacity=self.capacity)
            if mask is not None and self.mask_type_ != MaskType.NO_MASK:
                y = apply_mask_sparse_style(y, mask, self.mask_type_, zero)
            return y

    def apply(self, sv: SparseVector, mask: torch.Tensor | None = None
              ) -> tuple[SparseVector, torch.Tensor]:
        """Functional core: (sparse results, dense results), in the span
        `module.spmspv`."""
        with span("module.spmspv"):
            if self.engine is None:
                return spmspv_coo(self._coo, sv, self.semiring_, mask,
                                  self.mask_type_, capacity=self.capacity)
            zero = self.semiring_.zero
            y = self._run_engine(sparse_to_dense(sv, self.num_cols_, zero))
            if mask is not None and self.mask_type_ != MaskType.NO_MASK:
                y = apply_mask_sparse_style(y, mask, self.mask_type_, zero)
            return dense_to_sparse(y, zero, self.capacity), y

    def run(self) -> None:
        mask = (self.mask_buf.value if self.mask_type_ != MaskType.NO_MASK
                else None)
        self.results_buf.value, _ = self.apply(self.vector_buf.value, mask)

    # ---- CPU oracle ------------------------------------------------------
    def compute_reference_results(self, sparse_vector, mask=None) -> np.ndarray:
        """Float64 CPU oracle: the product over the active columns only.
        `sparse_vector` is a SparseVector or an (indices, values) pair."""
        if isinstance(sparse_vector, SparseVector):
            n = int(sparse_vector.nnz)
            idx = sparse_vector.indices[:n].cpu().numpy()
            val = sparse_vector.values[:n].cpu().numpy().astype(np.float64)
        else:
            idx = np.asarray(sparse_vector[0])
            val = np.asarray(sparse_vector[1], np.float64)
        csc = self.csc_matrix_
        y = np.full(self.num_rows_, self.semiring_.zero, np.float64)
        for vecv, c in zip(val, idx):
            lo, hi = csc.adj_indptr[c], csc.adj_indptr[c + 1]
            rr = csc.adj_indices[lo:hi].astype(np.int64)
            mm = csc.adj_data[lo:hi].astype(np.float64)
            if self.semiring_.op == OpType.MULADD:
                np.add.at(y, rr, mm * vecv)
            elif self.semiring_.op == OpType.ANDOR:
                c2 = np.logical_and(mm != 0, vecv != 0).astype(np.float64)
                y[rr] = np.logical_or(y[rr] != 0, c2 != 0).astype(np.float64)
            else:
                np.minimum.at(y, rr, np.minimum(mm + vecv, float(FLOAT_INF)))
        if mask is not None and self.mask_type_ != MaskType.NO_MASK:
            m = np.asarray(mask, np.float64)
            zero = self.semiring_.zero
            if self.mask_type_ == MaskType.WRITE_TO_ONE:
                y[m == zero] = zero
            else:
                y[m != zero] = zero
        return y
