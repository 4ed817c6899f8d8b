"""Chunked SpMV engine: gather -> semiring product -> fold into 128-row
windows, on Hopper.

Counterpart of `PallasSpMV` in graphlily_tpu/ops/spmv_pallas.py:400, over
the same `ChunkedSpMVLayout` arrays (either package's layout: both are
plain numpy and identical), for all three semirings. It is the ladder's
engine for graphs under 2M edges and for tropical matrices whose layout
fits (io/formatter.estimate_chunk_layout_gb).

One CUDA kernel (csrc/chunked_spmv.cu) replaces both Pallas kernels, the
streamed K6 and the resident K7: they compute the same y and differ only in
TPU memory placement. `spmv` runs it on CUDA tensors and its plain PyTorch
version (`spmv_plain`: gather, semiring product, `scatter_reduce_` sum or
amin into a y filled with the semiring zero) only when given CPU tensors;
each launch adds one to `launches["chunked"]`. `__call__` adds the ANDOR
0/1 clamp and the SpMV mask, as the JAX engine does.

Tropical x must be >= 0: padding slots hold INF, and min(x + INF, INF) is
the identity only then (the contract of the JAX engine's tests and of the
tropical engine). The JAX engine's `resident`, `interpret`, `reduce_mode`
and `fuse_dots` knobs and its 3-D output view are TPU-only and not carried
over. The predicated form (SpMSpV) comes with the SpMSpV port.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.formatter import ChunkedSpMVLayout, S, L, W, C
from ..semiring import Semiring, OpType, MaskType, apply_mask
from . import _build


@dataclasses.dataclass
class ChunkArrays:
    """The layout's streams on one device, flattened (`inv` stays on the
    host: only the TPU's segmented-scan reduce reads it)."""

    code: torch.Tensor   # (NC,) int32
    r: torch.Tensor      # (NC*1024,) int8
    rows: torch.Tensor   # (NC*1024,) int8
    vals: torch.Tensor   # (NC*1024,) float32


class ChunkedSpMV:
    """Chunked SpMV over a fixed layout. Same call surface as the JAX
    engine: `__call__(x, mask, mask_type, arrays)`."""

    def __init__(self, layout: ChunkedSpMVLayout, semiring: Semiring,
                 config: EngineConfig = DEFAULT_CONFIG,
                 mask_type: MaskType = MaskType.NO_MASK):
        if config.dtype != "float32":
            raise ValueError("the chunked kernel computes in float32 only")
        if (layout.inv is not None) != (semiring.op == OpType.ADDMIN):
            raise ValueError(
                "the layout's pad value is not the semiring zero: pack with "
                "pack_csr_chunks(pad_val=semiring.zero)")
        self.semiring = semiring
        self.mask_type = mask_type
        self.device = config.resolve_device()
        self.num_rows, self.num_cols = layout.num_rows, layout.num_cols
        self.num_chunks = layout.num_chunks
        self.nct = layout.num_col_tiles
        self.nnz = layout.nnz
        self.out_len = layout.num_window_groups * S * W
        dev = lambda a: torch.from_numpy(a).reshape(-1).to(self.device)
        self.arrays = ChunkArrays(code=dev(layout.code), r=dev(layout.r),
                                  rows=dev(layout.rows),
                                  vals=dev(layout.vals.astype("float32")))
        self.launches = {"chunked": 0}
        self._plain_index = None

    def spmv(self, x: torch.Tensor,
             arrays: ChunkArrays | None = None) -> torch.Tensor:
        """y = A (x) x over all nwgrp*1024 rows, before clamp and mask."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("x: need a contiguous float32 tensor")
        if x.numel() != self.num_cols:
            raise ValueError(f"x: {x.numel()} elements, expected "
                             f"{self.num_cols}")
        if x.device != a.vals.device:
            raise ValueError(f"x on {x.device}, engine arrays on "
                             f"{a.vals.device}")
        if not x.is_cuda:
            return self.spmv_plain(x, a)
        y = torch.full((self.out_len,), self.semiring.zero,
                       dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.code, a.r, a.rows, a.vals, x, y)]
        rc = _build.library().glt_chunked_spmv(
            *ptrs, self.num_chunks, self.nct, int(self.semiring.op),
            float(self.semiring.zero),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"glt_chunked_spmv: kernel launch failed with "
                               f"CUDA error {rc}")
        self.launches["chunked"] += 1
        return y

    def plain_index(self, a: ChunkArrays | None = None):
        """(col, row) of every slot, int64, expanded once from the code,
        lane and row streams."""
        if a is None and self._plain_index is not None:
            return self._plain_index
        arr = self.arrays if a is None else a
        code = arr.code.long().repeat_interleave(S * L)
        sub = torch.arange(S, device=code.device).repeat_interleave(L).repeat(
            self.num_chunks)
        window = torch.div(code, self.nct, rounding_mode="floor")
        col = (code - window * self.nct) * C + sub * L + arr.r.long()
        row = window * W + arr.rows.long()
        if a is None:
            self._plain_index = (col, row)
        return col, row

    def spmv_plain(self, x: torch.Tensor,
                   a: ChunkArrays | None = None) -> torch.Tensor:
        """The kernel's plain version: gather, semiring product, then
        `scatter_reduce_` (sum, or amin for ADDMIN) into a y filled with
        the semiring zero, padding slots included."""
        arr = self.arrays if a is None else a
        col, row = self.plain_index(a)
        g = self.semiring.mul(arr.vals, x.reshape(-1)[col])
        y = torch.full((self.out_len,), self.semiring.zero,
                       dtype=torch.float32, device=x.device)
        reduce = "amin" if self.semiring.op == OpType.ADDMIN else "sum"
        return y.scatter_reduce_(0, row, g, reduce, include_self=True)

    def __call__(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                 mask_type: MaskType | None = None,
                 arrays: ChunkArrays | None = None) -> torch.Tensor:
        """One SpMV, y = mask(A (x) x), (num_rows,)."""
        mt = self.mask_type if mask_type is None else mask_type
        y = self.spmv(x, arrays)[:self.num_rows]
        if self.semiring.op == OpType.ANDOR:
            y = (y != 0).to(y.dtype)
        if mask is not None and mt != MaskType.NO_MASK:
            y = apply_mask(y, mask, mt, self.semiring.zero)
        return y

    def call_predicated(self, *args, **kw):
        raise NotImplementedError(
            "the predicated chunked kernel (K7 over active chunk batches) "
            "belongs to SpMSpV, which is not ported yet (ROADMAP queue 1, "
            "item 8)")
