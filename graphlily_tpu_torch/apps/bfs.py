"""BFS as graph linear algebra (pull).

Counterpart of the pull half of `graphlily_tpu/apps/bfs.py`: logical
semiring; SpMV masked WRITE_TO_ZERO against the distance vector (visited
vertices drop out), then a dense assign WRITE_TO_ONE stamps `iter + 1`
into the distances at the new frontier. The JAX app's
`fori_loop(1, n + 1)` is a plain loop of launches here. Push and
pull_push need SpMSpV, which is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import LogicalSemiring, MaskType
from ..io.matrix import CSRMatrix, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim
from ..module import SpMVModule, AssignVectorDenseModule
from ..ops.reference import assign_vector_dense
from .module_collection import ModuleCollection

_NEEDS_SPMSPV = ("BFS push needs the SpMSpV engine, which is not ported yet "
                 "(ROADMAP queue 1, item 8)")


class BFS(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.semiring_ = LogicalSemiring

        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.WRITE_TO_ZERO)
        self.add_module(self.SpMV_)

        self.DenseAssign_ = AssignVectorDenseModule(config)
        self.DenseAssign_.set_mask_type(MaskType.WRITE_TO_ONE)
        self.add_module(self.DenseAssign_)

        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False):
        """Accepts a CSRMatrix or an npz path: round dims, set all weights
        to 1, format for the SpMV engine."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        csr_matrix = self._maybe_relabel(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()

    def _init_state(self, source: int):
        n = self.matrix_num_rows_
        frontier = torch.zeros(n, dtype=self.config.torch_dtype)
        distance = torch.zeros(n, dtype=self.config.torch_dtype)
        frontier[source] = 1
        distance[source] = 1
        return frontier.to(self.device), distance.to(self.device)

    def pull(self, source: int, num_iterations: int,
             device_output: bool = False):
        """Iterations 1..num_iterations: masked SpMV, then distance =
        iter + 1 at the new frontier."""
        source = self._internal_source(source)
        frontier, distance = self._init_state(source)
        for it in range(1, num_iterations + 1):
            frontier = self.SpMV_.apply(frontier, distance)
            distance = assign_vector_dense(distance, frontier, it + 1,
                                           MaskType.WRITE_TO_ONE)
        if device_output:
            return distance
        return self._external(distance.cpu().numpy())

    def push(self, source: int, num_iterations: int, *args, **kw):
        raise NotImplementedError(_NEEDS_SPMSPV)

    def pull_push(self, source: int, num_iterations: int, *args, **kw):
        raise NotImplementedError(_NEEDS_SPMSPV)

    def compute_reference_results(self, source: int, num_iterations: int):
        """Float64 CPU oracle."""
        source = self._internal_source(source)
        n = self.matrix_num_rows_
        input_ = np.zeros(n, np.float64)
        distance = np.zeros(n, np.float64)
        input_[source] = 1
        distance[source] = 1
        for it in range(1, num_iterations + 1):
            input_ = self.SpMV_.compute_reference_results(input_, distance)
            self.DenseAssign_.compute_reference_results(
                input_, distance, n, it + 1)
        return self._external(distance)
