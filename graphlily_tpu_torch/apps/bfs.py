"""BFS as graph linear algebra: pull, push and pull_push.

Counterpart of `graphlily_tpu/apps/bfs.py`: logical semiring. Pull is a
SpMV masked WRITE_TO_ZERO against the distance vector (visited vertices
drop out), then a dense assign WRITE_TO_ONE stamps `iter + 1` into the
distances at the new frontier (in the span `bfs.assign`, with pull_push's
frontier count). Push is the same step through the SpMSpV module (its
frontier-predicated kernels), whose engine is the SpMV module's own when
that is a router (`reuse_from`). pull_push pushes while the frontier is
sparse, then pulls.

The JAX app's `fori_loop`s are plain loops of launches here. Its
`while_loop` (pull_push) is a host loop that reads the 4-byte frontier
nnz once per push step, the reference's `get_results_nnz`; nothing else
is read back. The iteration semantics are JAX's fused loop's
(`bfs.py:158-193`): iteration 1 always pushes; another push runs while
it + 1 < num_iterations and nnz / n < threshold (in float32); pull runs
the rest.

The query's state lives on the engines' device (ops/bfs_step.py):
`init_state` writes the initial frontier and distance there and zeroes
one int32 count slot per iteration. On the card (`level_step`) the two
modules skip their engines' epilogue (`epilogue = False`), and after
each walk one launch of `bfs_step.step` (span `ops.bfs.step` inside
`bfs.assign`, counted in the app's `launches["step"]`) clamps and masks
the walk's output in place into the next frontier, stamps it + 1 into
the distances and counts the frontier into the iteration's slot, which
pull_push reads. On the CPU the modules clamp and mask, the dense
assign stamps, and pull_push counts the frontier with torch ops.
"""
from __future__ import annotations

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import LogicalSemiring, MaskType
from ..io.matrix import CSRMatrix, csr2csc, load_csr_matrix_from_float_npz
from ..io.formatter import util_round_csr_matrix_dim
from ..module import (SpMVModule, SpMSpVModule, eWiseAddModule,
                      AssignVectorDenseModule, AssignVectorSparseModule)
from ..ops import _build, bfs_step
from ..ops.reference import assign_vector_dense
from ..utils.profiling import span
from .module_collection import ModuleCollection


def keep_pushing(it: int, num_iterations: int, nnz: int, n: int,
                 threshold: float) -> bool:
    """pull_push's switch after `it` push iterations whose last frontier
    holds `nnz` entries: JAX's `it + 1 < num_iterations and nnz / n <
    threshold`, in float32 as there."""
    sparse = np.float32(nnz) / np.float32(n) < np.float32(threshold)
    return it + 1 < num_iterations and bool(sparse)


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

        self.SpMSpV_ = SpMSpVModule(config)
        self.SpMSpV_.set_semiring(self.semiring_)
        self.SpMSpV_.set_mask_type(MaskType.WRITE_TO_ZERO)
        self.add_module(self.SpMSpV_)

        self.SparseAssign_ = AssignVectorSparseModule(
            generate_new_frontier=False, config=config)
        self.add_module(self.SparseAssign_)

        self.eWiseAdd_ = eWiseAddModule(config)
        self.add_module(self.eWiseAdd_)

        self.matrix_num_rows_ = 0
        self.matrix_num_cols_ = 0
        self.launches = _build.Launches("bfs", ("step",))
        self.level_step = False   # set by load_and_format_matrix

    def get_nnz(self) -> int:
        return self.SpMV_.get_nnz()

    def load_and_format_matrix(self, csr_matrix, skip_empty_rows: bool = False):
        """Accepts a CSRMatrix or an npz path: round dims, set all weights
        to 1, format for the SpMV engine, build the CSC twin for SpMSpV
        (sharing the SpMV module's router engine)."""
        if not isinstance(csr_matrix, CSRMatrix):
            csr_matrix = load_csr_matrix_from_float_npz(csr_matrix)
        csr_matrix = csr_matrix.copy()
        csr_matrix = self._maybe_relabel(csr_matrix)
        util_round_csr_matrix_dim(csr_matrix, 1024, 1024)
        csr_matrix.adj_data = np.ones_like(csr_matrix.adj_data)
        self.SpMV_.load_and_format_matrix(csr_matrix, skip_empty_rows)
        self.SpMSpV_.load_and_format_matrix(csr2csc(csr_matrix),
                                            reuse_from=self.SpMV_)
        self.matrix_num_rows_ = self.SpMV_.get_num_rows()
        self.matrix_num_cols_ = self.SpMV_.get_num_cols()
        assert self.matrix_num_rows_ == self.matrix_num_cols_
        # on the card the level step clamps and masks the walks' output
        # (the COO engine, "xla", keeps its own)
        self.level_step = self.device.type == "cuda"
        for m in (self.SpMV_, self.SpMSpV_):
            m.epilogue = m.engine is None or not self.level_step

    def send_matrix_host_to_device(self):
        self.SpMV_.send_matrix_host_to_device()
        self.SpMSpV_.send_matrix_host_to_device()

    def _init_state(self, source: int, slots: int):
        """(frontier, distance, `slots` zeroed count slots)."""
        with span("apps.init"):
            return bfs_step.init_state(self.matrix_num_rows_, source, slots,
                                       self.config.torch_dtype, self.device)

    # ---- one iteration ---------------------------------------------------
    def _level(self, it: int, y, distance, counts):
        """(next frontier, distance) from iteration `it`'s walk output y:
        on the card one launch of the level step, which counts the
        frontier into slot it - 1; on the CPU y is the module's clamped,
        masked output, and the dense assign stamps it + 1 where it is
        nonzero."""
        with span("bfs.assign"):
            if self.level_step:
                y, distance, _ = bfs_step.step(y, distance, counts[it - 1],
                                               it + 1, self.launches)
                return y, distance
            return y, assign_vector_dense(distance, y, it + 1,
                                          MaskType.WRITE_TO_ONE)

    def _pull_step(self, it: int, frontier, distance, counts):
        """Iteration `it` (1-based): masked SpMV, then distance = it + 1 at
        the new frontier."""
        with span("apps.pull_step"):
            return self._level(it, self.SpMV_.apply(frontier, distance),
                               distance, counts)

    def _push_step(self, it: int, frontier, distance, counts):
        """Iteration `it` through SpMSpV on the dense frontier, then the
        level step as a pull's."""
        return self._level(it, self.SpMSpV_.apply_dense(frontier, distance),
                           distance, counts)

    def _result(self, distance, device_output: bool):
        if device_output:
            return distance
        return self._external(distance.cpu().numpy())

    # ---- public API ------------------------------------------------------
    def pull(self, source: int, num_iterations: int,
             device_output: bool = False):
        """Iterations 1..num_iterations of the masked SpMV."""
        with span("apps.bfs.pull"):
            frontier, distance, counts = self._init_state(
                self._internal_source(source), num_iterations)
            for it in range(1, num_iterations + 1):
                frontier, distance = self._pull_step(it, frontier, distance,
                                                     counts)
            return self._result(distance, device_output)

    def push(self, source: int, num_iterations: int, chained: bool = False,
             device_output: bool = False):
        """Iterations 1..num_iterations of SpMSpV. `chained` runs the
        module-by-module sequence through DeviceBuffers instead."""
        with span("apps.bfs.push"):
            source = self._internal_source(source)
            if chained:
                return self._external(self._push_chained(source,
                                                          num_iterations))
            frontier, distance, counts = self._init_state(source,
                                                          num_iterations)
            for it in range(1, num_iterations + 1):
                with span("apps.push_step"):
                    frontier, distance = self._push_step(it, frontier,
                                                         distance, counts)
            return self._result(distance, device_output)

    def pull_push(self, source: int, num_iterations: int,
                  threshold: float = 0.05, device_output: bool = False):
        """Push while the frontier is sparse (one 4-byte nnz read per push
        step), then pull for the remaining iterations."""
        with span("apps.bfs.pull_push"):
            n = self.matrix_num_rows_
            # a slot per iteration: iteration 1 always pushes
            frontier, distance, counts = self._init_state(
                self._internal_source(source), max(num_iterations, 1))
            it = 0
            while True:
                it += 1
                with span("apps.push_step"):
                    frontier, distance = self._push_step(it, frontier,
                                                         distance, counts)
                    count = counts[it - 1]
                    if not self.level_step:
                        with span("bfs.assign"):
                            count = (frontier != 0).sum()
                    with span("apps.host_read"):
                        nnz = int(count)
                if not keep_pushing(it, num_iterations, nnz, n, threshold):
                    break
            while it < num_iterations:
                it += 1
                frontier, distance = self._pull_step(it, frontier, distance,
                                                     counts)
            return self._result(distance, device_output)

    def _push_chained(self, source: int, num_iterations: int) -> np.ndarray:
        """The reference call sequence, module by module: SpMSpV, copy the
        results into the frontier buffer, sparse assign it + 1."""
        _, distance, _ = self._init_state(source, 0)
        self.SpMSpV_.send_vector_host_to_device(([source], [1.0]))
        self.SpMSpV_.send_mask_host_to_device(distance.cpu().numpy())
        self.SparseAssign_.bind_mask_buf(self.SpMSpV_.vector_buf)
        self.SparseAssign_.bind_inout_buf(self.SpMSpV_.mask_buf)
        for it in range(1, num_iterations + 1):
            self.SpMSpV_.run()
            self.SpMSpV_.copy_buffer_device_to_device(
                self.SpMSpV_.results_buf, self.SpMSpV_.vector_buf)
            self.SparseAssign_.run(it + 1)
        return self.SpMSpV_.send_mask_device_to_host()

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
