"""SSSP as tropical-semiring linear algebra: pull, push and pull_push.

Counterpart of `graphlily_tpu/apps/sssp.py`: tropical (+, min) semiring,
no mask. Preprocessing inserts zero-weight self edges so distances stay
monotone under relaxation. The ladder formats the matrix for the chunked
engine while its layout is feasible (up to 700,000 rows and 2 GB) and
for the tropical engine past that (ops/tropical.py: the pokec stand-in
and larger); the SpMSpV module packs its own chunked twin or shares the
tropical engine. Pull is distance = A (min,+) distance. Push relaxes
through the SpMSpV module (K7p on the chunked engine, K4p scatter ->
K8/K9 -> K10 on the tropical one): with
y = A (min,+) frontier, improved = y < distance, the distance takes y
where improved, the new frontier is y there and INF elsewhere, and its
nnz is the improved count. pull_push pushes while the frontier is sparse
(one 4-byte nnz read per push step), then pulls, with JAX's fused-loop
iteration semantics (see apps/bfs.py). The JAX app's loops are plain
loops of launches here.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import TropicalSemiring, MaskType
from ..io.matrix import CSRMatrix, csr2csc, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim, add_self_edges_for_sssp
from ..module import SpMVModule, SpMSpVModule
from ..utils.profiling import PhaseTimer, sync, dispatch_floor_ms
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

    def _init_distance(self, source: int) -> torch.Tensor:
        d = torch.full((self.matrix_num_rows_,), self.semiring_.zero,
                       dtype=self.config.torch_dtype)
        d[source] = 0
        return d.to(self.device)

    def _relax(self, y, distance):
        """(distance, new frontier, improved): the frontier's nnz is
        improved.sum()."""
        improved = y < distance
        return (torch.where(improved, y, distance),
                torch.where(improved, y, self.semiring_.zero), improved)

    def _push_step(self, frontier, distance):
        return self._relax(self.SpMSpV_.apply_dense(frontier), distance)

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
        distance = self._init_distance(self._internal_source(source))
        for _ in range(num_iterations):
            distance = self.SpMV_.apply(distance)
        return self._result(distance, device_output)

    def push(self, source: int, num_iterations: int,
             device_output: bool = False):
        """`num_iterations` relaxations from the frontier only; the first
        frontier is the source at distance 0."""
        distance = self._init_distance(self._internal_source(source))
        frontier = distance
        for _ in range(num_iterations):
            distance, frontier, _ = self._push_step(frontier, distance)
        return self._result(distance, device_output)

    def pull_push(self, source: int, num_iterations: int,
                  threshold: float = 0.05, device_output: bool = False):
        """Push while the frontier is sparse, then pull on the distances."""
        n = self.matrix_num_rows_
        distance = self._init_distance(self._internal_source(source))
        frontier = distance
        it = 0
        while True:
            it += 1
            distance, frontier, improved = self._push_step(frontier, distance)
            nnz = int(improved.sum())
            if not keep_pushing(it, num_iterations, nnz, n, threshold):
                break
        for _ in range(it, num_iterations):
            distance = self.SpMV_.apply(distance)
        return self._result(distance, device_output)

    def pull_push_time_breakdown(self, source: int, num_iterations: int,
                                 threshold: float = 0.05) -> dict:
        """pull_push with host timings per phase, each phase synchronized;
        the same iteration counts as pull_push (see BFS)."""
        source = self._internal_source(source)
        n = self.matrix_num_rows_
        dev = self.device
        d0 = self._init_distance(source)
        self._push_step(d0, d0)                 # warm-up
        self.SpMV_.apply(d0)
        sync(dev)
        floor_ms = dispatch_floor_ms(dev)

        timer = PhaseTimer()
        calls = {"spmspv": 0, "relax": 0, "nnz_readback": 0, "spmv": 0}
        distance = self._init_distance(source)
        frontier = distance
        it = push_iters = pull_iters = 0
        t_all = time.perf_counter()
        while True:
            it += 1
            push_iters += 1
            with timer.phase("push_spmspv"):
                y = self.SpMSpV_.apply_dense(frontier)
                sync(dev)
            with timer.phase("push_relax"):
                distance, frontier, improved = self._relax(y, distance)
                sync(dev)
            with timer.phase("nnz_readback"):
                nnz_host = int(improved.sum())
            for k in ("spmspv", "relax", "nnz_readback"):
                calls[k] += 1
            if not keep_pushing(it, num_iterations, nnz_host, n, threshold):
                break
        while it < num_iterations:
            it += 1
            pull_iters += 1
            with timer.phase("pull_spmv"):
                distance = self.SpMV_.apply(distance)
                sync(dev)
            calls["spmv"] += 1
        total_ms = (time.perf_counter() - t_all) * 1e3
        ncalls = sum(calls.values())
        return {
            "phases_ms": dict(timer.times_ms),
            "push_iterations": push_iters,
            "pull_iterations": pull_iters,
            "calls": calls,
            "dispatch_floor_ms": floor_ms,
            "dispatch_overhead_ms": floor_ms * ncalls,
            "total_ms": total_ms,
            "total_minus_dispatch_ms": max(total_ms - floor_ms * ncalls, 0.0),
            "distance": self._external(distance.cpu().numpy()),
        }

    def compute_reference_results(self, source: int, num_iterations: int):
        """Float64 CPU oracle."""
        d = np.full(self.matrix_num_rows_, self.semiring_.zero, np.float64)
        d[self._internal_source(source)] = 0
        for _ in range(num_iterations):
            d = self.SpMV_.compute_reference_results(d)
        return self._external(d)
