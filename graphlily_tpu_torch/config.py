"""Engine configuration for the PyTorch/CUDA port.

Counterpart of `graphlily_tpu/config.py`, keeping the fields the ported
slice reads. The port computes every value in float32; `mxu_precision` is
accepted for call-site parity with the JAX package and changes nothing:
the CUDA kernels never use tensor cores, and the plain PyTorch versions
run with TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`, which
`chip_smoke.py` sets and prints).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dtype: str = "float32"           # value dtype
    engine: str = "auto"             # "auto" | "xla" | "pallas" | "router"
                                     # | "roll" | "planar" (same ladder as
                                     # the JAX package; "pallas" names the
                                     # chunked engine; the chunked, roll
                                     # and planar engines and the reference
                                     # "xla" engine are ported, the
                                     # tropical engine is not)
    sort_rows_by_degree: bool = False  # symmetric degree-sort relabel
    mxu_precision: str = "highest"   # accepted, ignored (always fp32)
    device: Optional[str] = None     # None: "cuda" when a card is present,
                                     # else "cpu"
    planar_deal: str = "free"        # planar layout deal: "free" (chained
                                     # gather) or "bucket" (x re-laid by
                                     # K5)

    def __post_init__(self):
        if self.planar_deal == "permc":
            raise NotImplementedError(
                "planar_deal='permc' (PERM-C layouts) is not ported yet "
                "(ROADMAP queue 1, item 11)")
        if self.planar_deal not in ("free", "bucket"):
            raise ValueError(f"unknown planar_deal {self.planar_deal!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def resolve_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def resolve_engine(self) -> str:
        return self.engine   # "auto" resolves per module (capability ladder)


DEFAULT_CONFIG = EngineConfig()
