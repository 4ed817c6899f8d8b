"""Apply modules: eWiseAdd and dense assign.

Counterparts of `eWiseAddModule` and `AssignVectorDenseModule` in
`graphlily_tpu/module/apply_modules.py`. The sparse assign comes with the
SpMSpV port.
"""
from __future__ import annotations

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import MaskType
from ..ops.reference import ewise_add_scalar, assign_vector_dense
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
