"""Apply modules: eWiseAdd, dense assign and sparse assign.

Counterparts of `eWiseAddModule`, `AssignVectorDenseModule` and
`AssignVectorSparseModule` in `graphlily_tpu/module/apply_modules.py`.
"""
from __future__ import annotations

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import MaskType
from ..ops.reference import (ewise_add_scalar, assign_vector_dense,
                             assign_vector_sparse_no_new_frontier,
                             assign_vector_sparse_new_frontier)
from ..ops.vector import SparseVector
from .base import BaseModule, DeviceBuffer


class eWiseAddModule(BaseModule):
    """out[i] = in[i] + val. With val = 0 it is the vector copy."""

    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.in_buf = DeviceBuffer()
        self.out_buf = DeviceBuffer()

    def bind_in_buf(self, buf: DeviceBuffer) -> None:
        self.in_buf = buf

    def bind_out_buf(self, buf: DeviceBuffer) -> None:
        self.out_buf = buf

    def send_in_host_to_device(self, v) -> None:
        self.in_buf.value = self._to_device(v)

    def send_out_device_to_host(self) -> np.ndarray:
        return self.out_buf.value.cpu().numpy()

    def run(self, length: int | None = None, val: float = 0.0) -> None:
        self.out_buf.value = ewise_add_scalar(self.in_buf.value, val, length)

    @staticmethod
    def compute_reference_results(in_vec, length: int, val: float) -> np.ndarray:
        return np.asarray(in_vec, np.float64)[:length] + val


class AssignVectorDenseModule(BaseModule):
    """if mask[i] (== 0 / != 0) then inout[i] = val."""

    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.mask_buf = DeviceBuffer()
        self.inout_buf = DeviceBuffer()

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    def bind_inout_buf(self, buf: DeviceBuffer) -> None:
        self.inout_buf = buf

    def send_mask_host_to_device(self, v) -> None:
        self.mask_buf.value = self._to_device(v)

    def send_inout_host_to_device(self, v) -> None:
        self.inout_buf.value = self._to_device(v)

    def send_inout_device_to_host(self) -> np.ndarray:
        return self.inout_buf.value.cpu().numpy()

    def run(self, length: int | None = None, val: float = 0.0) -> None:
        if self.mask_type_ == MaskType.NO_MASK:
            raise ValueError("dense assign needs a mask type")
        self.inout_buf.value = assign_vector_dense(
            self.inout_buf.value, self.mask_buf.value, val, self.mask_type_)

    def compute_reference_results(self, mask, inout, length: int,
                                  val: float) -> None:
        """In-place numpy oracle, reference signature (mask, inout, len, val)."""
        m = np.asarray(mask)[:length]
        if self.mask_type_ == MaskType.WRITE_TO_ZERO:
            inout[:length][m == 0] = val
        else:
            inout[:length][m != 0] = val


class AssignVectorSparseModule(BaseModule):
    """Sparse assign. Without `generate_new_frontier`:
    inout[idx] = val at the mask's entries (BFS push); with it, the SSSP
    relaxation, which also emits the improved entries as a new frontier."""

    def __init__(self, generate_new_frontier: bool,
                 config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(config)
        self.generate_new_frontier = generate_new_frontier
        self.mask_buf = DeviceBuffer()          # SparseVector
        self.inout_buf = DeviceBuffer()         # dense
        self.new_frontier_buf = DeviceBuffer()  # SparseVector (frontier mode)

    def bind_mask_buf(self, buf: DeviceBuffer) -> None:
        self.mask_buf = buf

    def bind_inout_buf(self, buf: DeviceBuffer) -> None:
        self.inout_buf = buf

    def bind_new_frontier_buf(self, buf: DeviceBuffer) -> None:
        assert self.generate_new_frontier
        self.new_frontier_buf = buf

    def send_mask_host_to_device(self, sv: SparseVector) -> None:
        self.mask_buf.value = sv

    def send_inout_host_to_device(self, v) -> None:
        self.inout_buf.value = self._to_device(v)

    def send_inout_device_to_host(self) -> np.ndarray:
        return self.inout_buf.value.cpu().numpy()

    def run(self, val: float | None = None) -> None:
        if self.generate_new_frontier:
            if val is not None:
                raise ValueError("frontier mode takes no val")
            new_inout, nf = assign_vector_sparse_new_frontier(
                self.inout_buf.value, self.mask_buf.value)
            self.inout_buf.value = new_inout
            self.new_frontier_buf.value = nf
        else:
            if val is None:
                raise ValueError("val required")
            self.inout_buf.value = assign_vector_sparse_no_new_frontier(
                self.inout_buf.value, self.mask_buf.value, val)

    @staticmethod
    def compute_reference_results_no_new_frontier(mask_idx, inout,
                                                  val) -> None:
        inout[np.asarray(mask_idx, np.int64)] = val

    @staticmethod
    def compute_reference_results_new_frontier(mask_idx, mask_val, inout):
        """Returns the new frontier's (idx, val) arrays; updates inout in
        place."""
        nf_idx, nf_val = [], []
        for i, v in zip(mask_idx, mask_val):
            if inout[i] > v:
                inout[i] = v
                nf_idx.append(i)
                nf_val.append(v)
        return np.asarray(nf_idx), np.asarray(nf_val)
