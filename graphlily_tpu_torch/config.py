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
                                     # and planar engines, the tropical
                                     # engine and the reference "xla"
                                     # engine are all ported)
    sort_rows_by_degree: bool = False  # symmetric degree-sort relabel
    mxu_precision: str = "highest"   # accepted, ignored (always fp32)
    device: Optional[str] = None     # None: "cuda" (raises without a
                                     # card); the CPU only by name
    planar_deal: str = "free"        # planar layout deal: "free" (chained
                                     # gather), "bucket" (x re-laid by K5)
                                     # or "permc" (PERM-C: chained gather,
                                     # K11 reduces the split branch)
    tropical_split_format: str = "auto"  # tropical split-pass deposits:
                                     # "planes" (1 KB int8 gather plane a
                                     # piece, K8), "triples" (a digit sort
                                     # plane a chunk + 32 B of run words a
                                     # piece, K9) or "auto" (triples from
                                     # ~67M nnz; io/tropical_format.
                                     # resolve_tropical_split_format)
    frontier_capacity: Optional[int] = None  # SpMSpV sparse-vector capacity;
                                             # None: the matrix's row count

    def __post_init__(self):
        if self.planar_deal not in ("free", "bucket", "permc"):
            raise ValueError(f"unknown planar_deal {self.planar_deal!r}")
        if self.tropical_split_format not in ("auto", "planes", "triples"):
            raise ValueError(f"unknown tropical_split_format "
                             f"{self.tropical_split_format!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def resolve_device(self) -> torch.device:
        """The named device, else the card. The kernels run only there:
        with no card present this raises instead of giving the CPU, which
        a caller (the tests) asks for by name, `device="cpu"`."""
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's kernels run on the card; pass "
                "EngineConfig(device='cpu') for the plain PyTorch versions")
        return torch.device("cuda")

    def resolve_engine(self) -> str:
        return self.engine   # "auto" resolves per module (capability ladder)


DEFAULT_CONFIG = EngineConfig()
