"""Module base: semiring/mask state, the engine config, and `DeviceBuffer`.

Counterpart of `graphlily_tpu/module/base.py`. `DeviceBuffer` reproduces
the reference's buffer binding: a bind makes two modules share one mutable
holder, so one module's `run()` output is the next module's input without
a host copy. The held tensors stay on the module's device.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import Semiring, MaskType


class DeviceBuffer:
    """Mutable holder for a device tensor."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def __repr__(self):
        return f"DeviceBuffer({type(self.value).__name__})"


class BaseModule:
    """Holds the semiring, the mask type, the engine config and the device
    the module's tensors live on."""

    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        self.config = config
        self.device = config.resolve_device()
        self.semiring_: Optional[Semiring] = None
        self.mask_type_: MaskType = MaskType.NO_MASK

    def set_semiring(self, semiring: Semiring) -> None:
        self.semiring_ = semiring

    def set_mask_type(self, mask_type: MaskType) -> None:
        self.mask_type_ = mask_type

    def _to_device(self, v) -> torch.Tensor:
        """A host vector as a tensor of the config's dtype on the module's
        device."""
        a = np.ascontiguousarray(np.asarray(v, self.config.dtype))
        return torch.from_numpy(a).to(self.device)

    def set_up_runtime(self, *_args, **_kw) -> None:
        """API-parity no-op (the reference programs the FPGA here)."""
        return None

    @staticmethod
    def copy_buffer_device_to_device(src: DeviceBuffer, dst: DeviceBuffer,
                                     _nbytes: int | None = None) -> None:
        """Results are never updated in place, so a reference copy is a
        copy."""
        dst.value = src.value
