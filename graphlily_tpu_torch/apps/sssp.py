"""SSSP as tropical-semiring linear algebra: pull, push and pull_push.

Counterpart of `graphlily_tpu/apps/sssp.py`: tropical (+, min) semiring,
no mask. Preprocessing inserts zero-weight self edges so distances stay
monotone under relaxation. The ladder formats the matrix for the chunked
engine while its layout is feasible (up to 700,000 rows and 2 GB) and
for the tropical engine past that (ops/tropical.py: the pokec stand-in
and larger); the SpMSpV module packs its own chunked twin or shares the
tropical engine. Pull is distance = A (min,+) distance. Push relaxes
through the SpMSpV module (K7p on the chunked engine, the predicated
walk `TropicalSpMV.call_predicated`, K4p fused ADDMIN, on the tropical
one): with y = A (min,+) frontier, improved = y < distance, the distance
takes y where improved, the new frontier is y there and INF elsewhere,
and its nnz is the improved count. pull_push pushes while the frontier
is sparse (one 4-byte nnz read per push step), then pulls, with JAX's
fused-loop iteration semantics (see apps/bfs.py). The JAX app's loops
are plain loops of launches here.

The query's state lives on the engines' device (ops/sssp_relax.py):
`init_state` writes the initial distance there and zeroes one int32 count
slot per iteration. On the card `relax` relaxes in place after each
SpMSpV, one kernel launch counted in the app's `launches["relax"]` (span
`ops.sssp.relax`), and adds the improved count to the step's slot, which
pull_push reads; CPU tensors take `relax_plain`.
"""
from __future__ import annotations

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import TropicalSemiring, MaskType
from ..io.matrix import CSRMatrix, csr2csc, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim, add_self_edges_for_sssp
from ..module import SpMVModule, SpMSpVModule
from ..ops import _build, sssp_relax
from ..utils.profiling import span
from .bfs import keep_pushing
from .module_collection import ModuleCollection


class SSSP(ModuleCollection):
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.semiring_ = TropicalSemiring
        self.SpMV_ = SpMVModule(config)
        self.SpMV_.set_semiring(self.semiring_)
        self.SpMV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMV_)
        self.SpMSpV_ = SpMSpVModule(config)
        self.SpMSpV_.set_semiring(self.semiring_)
        self.SpMSpV_.set_mask_type(MaskType.NO_MASK)
        self.add_module(self.SpMSpV_)
        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0
        self.launches = _build.Launches("sssp", ("relax",))

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False,
                               unit_weights: bool = True):
        """Accepts a CSRMatrix or an npz path: unit weights (SSSP then
        gives BFS levels) when `unit_weights`, relabel, self edges, round
        dims, format for the SpMV engine and the SpMSpV twin."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        if unit_weights:
            csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
        csr_matrix = self._maybe_relabel(csr_matrix)
        csr_matrix = add_self_edges_for_sssp(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.SpMSpV_.load_and_format_matrix(csr2csc(csr_matrix),
                                            reuse_from=self.SpMV_)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()
        self.SpMSpV_.send_matrix_host_to_device()

    def _init_state(self, source: int, slots: int):
        """(distance, `slots` zeroed count slots)."""
        with span("apps.init"):
            return sssp_relax.init_state(self.matrix_num_rows_, source, slots,
                                         self.config.torch_dtype, self.device)

    def _push_step(self, frontier, distance, counts, k: int):
        """(distance, new frontier, its nnz as a 0-dim tensor); on the
        card the relax runs in place and counts into slot k."""
        y = self.SpMSpV_.apply_dense(frontier)
        if not y.is_cuda:
            return sssp_relax.relax_plain(y, distance)
        return sssp_relax.relax(y, distance, counts[k], self.launches)

    def _result(self, distance, device_output: bool):
        if device_output:
            return distance
        return self._external(distance.cpu().numpy())

    # ---- public API ------------------------------------------------------
    def pull(self, source: int, num_iterations: int,
             device_output: bool = False):
        """`num_iterations` relaxations of every edge. With
        `device_output` the device tensor comes back, in the relabeled
        vertex order and without a host copy."""
        with span("apps.sssp.pull"):
            distance, _ = self._init_state(self._internal_source(source), 0)
            for _ in range(num_iterations):
                with span("apps.pull_step"):
                    distance = self.SpMV_.apply(distance)
            return self._result(distance, device_output)

    def push(self, source: int, num_iterations: int,
             device_output: bool = False):
        """`num_iterations` relaxations from the frontier only; the first
        frontier is the source at distance 0."""
        with span("apps.sssp.push"):
            distance, counts = self._init_state(
                self._internal_source(source), num_iterations)
            frontier = distance
            for k in range(num_iterations):
                with span("apps.push_step"):
                    distance, frontier, _ = self._push_step(
                        frontier, distance, counts, k)
            return self._result(distance, device_output)

    def pull_push(self, source: int, num_iterations: int,
                  threshold: float = 0.05, device_output: bool = False):
        """Push while the frontier is sparse, then pull on the distances."""
        with span("apps.sssp.pull_push"):
            n = self.matrix_num_rows_
            # a slot per push step: at most max(1, num_iterations - 1)
            distance, counts = self._init_state(
                self._internal_source(source), max(num_iterations, 1))
            frontier = distance
            it = 0
            while True:
                it += 1
                with span("apps.push_step"):
                    distance, frontier, count = self._push_step(
                        frontier, distance, counts, it - 1)
                    with span("apps.host_read"):
                        nnz = int(count)
                if not keep_pushing(it, num_iterations, nnz, n, threshold):
                    break
            for _ in range(it, num_iterations):
                with span("apps.pull_step"):
                    distance = self.SpMV_.apply(distance)
            return self._result(distance, device_output)

    def compute_reference_results(self, source: int, num_iterations: int):
        """Float64 CPU oracle."""
        d = np.full(self.matrix_num_rows_, self.semiring_.zero, np.float64)
        d[self._internal_source(source)] = 0
        for _ in range(num_iterations):
            d = self.SpMV_.compute_reference_results(d)
        return self._external(d)
