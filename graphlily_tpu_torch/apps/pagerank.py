"""PageRank.

Counterpart of `graphlily_tpu/apps/pagerank.py`: arithmetic semiring, no
mask. The matrix is outdegree-normalized and pre-scaled by the damping
factor at format time; one iteration is rank = A_scaled @ rank + (1-d)/N
(SpMV + eWiseAdd). The JAX app runs the iterations in `lax.fori_loop`;
here they are a plain loop of asynchronous launches with the same
semantics, and the host waits only when it reads the result. On the fused
walk (K1, K4 fused) an iteration is one launch: it adds into an output
that the launch before set up to (1-d)/N, and sets up the next one
(`SpMVModule.set_offset`), so the sum starts from the teleport term;
elsewhere the add follows the SpMV.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import ArithmeticSemiring, MaskType
from ..io.matrix import CSRMatrix, load_csr_matrix_from_float_npz
from ..io.formatter import (util_round_csr_matrix_dim,
                            util_normalize_csr_matrix_by_outdegree)
from ..module import SpMVModule, eWiseAddModule
from ..utils.profiling import span
from .module_collection import ModuleCollection


class PageRank(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.semiring_ = ArithmeticSemiring
        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMV_)
        self.eWiseAdd_ = eWiseAddModule(config)
        self.add_module(self.eWiseAdd_)
        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, damping: float = 0.9,
                               skip_empty_rows: bool = False):
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        csr_matrix = self._maybe_relabel(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        util_normalize_csr_matrix_by_outdegree(csr_matrix)
        csr_matrix.adj_data = (csr_matrix.adj_data * damping).astype(
            csr_matrix.adj_data.dtype)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()

    def pull(self, damping: float, num_iterations: int,
             device_output: bool = False):
        """`num_iterations` of rank = SpMV(rank) + (1 - damping)/n. With
        `device_output` the device tensor comes back, in the relabeled
        vertex order and without a host copy."""
        with span("apps.pagerank.pull"):
            n = self.matrix_num_rows_
            # rounded to the dtype once, as each iteration's add rounds it
            offset = np.array((1 - damping) / n, self.config.dtype).item()
            with span("apps.init"):
                rank = torch.full((n,), 1.0 / n,
                                  dtype=self.config.torch_dtype,
                                  device=self.device)
                self.SpMV_.set_offset(offset, num_iterations)
            try:
                for _ in range(num_iterations):
                    rank = self.SpMV_.apply(rank)
            finally:
                self.SpMV_.set_offset(None)
            if device_output:
                return rank
            return self._external(rank.cpu().numpy())

    def compute_reference_results(self, damping: float, num_iterations: int):
        """Float64 CPU oracle."""
        n = self.matrix_num_rows_
        rank = np.full(n, 1.0 / n, np.float64)
        for _ in range(num_iterations):
            rank = self.SpMV_.compute_reference_results(rank)
            rank = rank + (1 - damping) / n
        return self._external(rank)
