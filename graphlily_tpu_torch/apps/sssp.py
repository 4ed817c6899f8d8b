"""SSSP as tropical-semiring linear algebra (pull).

Counterpart of the pull half of `graphlily_tpu/apps/sssp.py`: tropical
(+, min) semiring, no mask. Preprocessing inserts zero-weight self edges
so distances stay monotone under relaxation; one iteration is
distance = A (min,+) distance. The JAX app's `fori_loop` is a plain loop
of launches here. Push and pull_push need SpMSpV, which is not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import TropicalSemiring, MaskType
from ..io.matrix import CSRMatrix, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim, add_self_edges_for_sssp
from ..module import SpMVModule
from .module_collection import ModuleCollection

_NEEDS_SPMSPV = ("SSSP push needs the SpMSpV engine, which is not ported "
                 "yet (ROADMAP queue 1, item 8)")


class SSSP(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.semiring_ = TropicalSemiring
        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMV_)
        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False,
                               unit_weights: bool = True):
        """Accepts a CSRMatrix or an npz path: unit weights (SSSP then
        gives BFS levels) when `unit_weights`, relabel, self edges, round
        dims, format for the SpMV engine."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        if unit_weights:
            csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
        csr_matrix = self._maybe_relabel(csr_matrix)
        csr_matrix = add_self_edges_for_sssp(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()

    def _init_distance(self, source: int) -> torch.Tensor:
        d = torch.full((self.matrix_num_rows_,), self.semiring_.zero,
                       dtype=self.config.torch_dtype)
        d[source] = 0
        return d.to(self.device)

    def pull(self, source: int, num_iterations: int,
             device_output: bool = False):
        """`num_iterations` relaxations of every edge. With
        `device_output` the device tensor comes back, in the relabeled
        vertex order and without a host copy."""
        distance = self._init_distance(self._internal_source(source))
        for _ in range(num_iterations):
            distance = self.SpMV_.apply(distance)
        if device_output:
            return distance
        return self._external(distance.cpu().numpy())

    def push(self, source: int, num_iterations: int, *args, **kw):
        raise NotImplementedError(_NEEDS_SPMSPV)

    def pull_push(self, source: int, num_iterations: int, *args, **kw):
        raise NotImplementedError(_NEEDS_SPMSPV)

    def compute_reference_results(self, source: int, num_iterations: int):
        """Float64 CPU oracle."""
        d = np.full(self.matrix_num_rows_, self.semiring_.zero, np.float64)
        d[self._internal_source(source)] = 0
        for _ in range(num_iterations):
            d = self.SpMV_.compute_reference_results(d)
        return self._external(d)
