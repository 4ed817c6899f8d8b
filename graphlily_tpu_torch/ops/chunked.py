"""Chunked SpMV engine: gather -> semiring product -> fold into 128-row
windows, on Hopper.

Counterpart of `PallasSpMV` in graphlily_tpu/ops/spmv_pallas.py:400, over
the same `ChunkedSpMVLayout` (either package's layout: both are plain
numpy and identical), for all three semirings. It is the ladder's engine
for graphs under 2M edges and for tropical matrices whose layout fits
(io/formatter.estimate_chunk_layout_gb).

The layout pads every (chunk, sublane) to 128 lanes: on the googleplus
SSSP matrix 81% of its slots are padding. At init the engine keeps only
the real entries (`chunk_entries`, the padding-free device form): each
entry's int8 lane, int8 row and float32 value in chunk-code order, the
(chunk, sublane) segments they come in, with each segment's x and y
offsets, and the grid: blocks of at most `ENTRIES_PER_BLOCK` entries
inside one 1024-row window group. The padded streams never reach the
device.

One CUDA kernel (csrc/chunked_spmv.cu) replaces both Pallas kernels, the
streamed K6 and the resident K7: they compute the same y and differ only in
TPU memory placement. `spmv` runs it on CUDA tensors and its plain PyTorch
version (`spmv_plain`: gather, semiring product, `scatter_reduce_` sum or
amin into a y filled with the semiring zero, over the same real entries)
only when given CPU tensors; each launch adds one to
`launches["chunked"]` inside the span `ops.chunked.chunked`. `__call__`
adds the ANDOR 0/1 clamp and the SpMV mask, as the JAX engine does.

SpMSpV (`call_predicated`) runs K7p, the same kernel with a column-tile
activity vector: the full grid, whose entries of inactive tiles are not
read. That is the work of JAX's kept 32-chunk batches (`touch @ act > 0`,
`spmspv_module.py:215-227`; `kept_batches` here) less their inactive
chunks, with no host read of the frontier. `spmv_predicated` launches it,
or runs `spmv_plain` over the active tiles' entries on CPU tensors, and
counts `launches["chunked_pred"]`.

The JAX engine's `resident`, `interpret`, `reduce_mode` and `fuse_dots`
knobs and its 3-D output view are TPU-only and not carried over.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.formatter import ChunkedSpMVLayout, S, L, W, C, CB
from ..semiring import Semiring, OpType, MaskType, apply_mask
from . import _build

# Real entries per block of the kernel's grid; chosen on the card (PERF.md,
# PR 7).
ENTRIES_PER_BLOCK = 4096
GROUP_ROWS = S * W     # rows of a window group: one block's y tile
VECTOR = 8             # entries a kernel thread loads at once


@dataclasses.dataclass
class ChunkArrays:
    """The padding-free device form of a chunked layout (`chunk_entries`).
    Entries are the layout's real slots, chunks in code order (a "col"
    layout gives the same form as a "row" one), slots in layout order
    within a chunk; a segment is the run of one (chunk, sublane)."""

    code: torch.Tensor        # (NC,) int32: the layout's chunk codes
    # (N,) each, views of storage zeroed to a multiple of VECTOR entries
    # (the kernel's vector loads; no block names an entry past N)
    r: torch.Tensor           # int8: x lane, col & 127
    rows: torch.Tensor        # int8: row - window base
    vals: torch.Tensor        # float32
    seg_start: torch.Tensor   # (nseg+1,) int32: first entry of each segment
    seg_x: torch.Tensor       # (nseg,) int32: col_tile*1024 + sublane*128
    seg_y: torch.Tensor       # (nseg,) int32: window*128
    blocks: torch.Tensor      # (nblk, 4) int32: entries [e0, e1), segments
                              # [g0, g1) of one window group
    max_segments: int         # largest g1 - g0 (the kernel's shared table)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.code, self.r, self.rows, self.vals, self.seg_start,
            self.seg_x, self.seg_y, self.blocks))


def entry_slots(code: torch.Tensor, el_slot: torch.Tensor) -> torch.Tensor:
    """Layout slot of every real entry, int64, in the padding-free order:
    chunks stably by code (a "row" layout keeps its order and a "col"
    layout takes the same one), slots in layout order within a chunk."""
    nc = code.numel()
    rank = torch.empty(nc, dtype=torch.int64, device=code.device)
    rank[torch.sort(code, stable=True).indices] = torch.arange(
        nc, device=code.device)
    slot = torch.sort(el_slot).values
    key = rank[slot // (S * L)] * (S * L) + slot % (S * L)
    return slot[torch.sort(key).indices]


def chunk_entries(layout: ChunkedSpMVLayout, device,
                  block_entries: int = ENTRIES_PER_BLOCK) -> ChunkArrays:
    """The padding-free device form of `layout`, built with torch ops on
    `device`: real entries from `el_slot`, their (chunk, sublane)
    segments, and blocks of at most `block_entries` entries that never
    cross a window group."""
    if layout.el_slot is None:
        raise ValueError("the layout has no el_slot: pack it with "
                         "pack_csr_chunks")
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).reshape(-1).to(
        device)
    nct = layout.num_col_tiles
    code = dev(layout.code)
    slot = entry_slots(code, dev(layout.el_slot))
    n = slot.numel()

    def gather(a):
        t = dev(a)
        out = torch.zeros(-(-n // VECTOR) * VECTOR, dtype=t.dtype,
                          device=device)[:n]
        return out.copy_(t[slot])
    r, rows = gather(layout.r), gather(layout.rows)
    vals = gather(layout.vals.astype(np.float32, copy=False))
    sub = slot // L                                  # (chunk, sublane) id
    head = torch.ones(n, dtype=torch.bool, device=device)
    head[1:] = sub[1:] != sub[:-1]
    starts = torch.nonzero(head).flatten()
    scode = code.long()[slot[starts] // (S * L)]
    window = torch.div(scode, nct, rounding_mode="floor")
    seg_x = (scode - window * nct) * C + (sub[starts] % S) * L
    seg_start = torch.cat([starts, torch.tensor([n], device=device)])
    # blocks: each window group's entries cut into ranges of block_entries
    group = torch.div(window, S, rounding_mode="floor")
    ghead = torch.ones(len(starts), dtype=torch.bool, device=device)
    ghead[1:] = group[1:] != group[:-1]
    g_e0 = starts[ghead]
    g_e1 = torch.cat([g_e0[1:], torch.tensor([n], device=device)])
    nb = torch.div(g_e1 - g_e0 + block_entries - 1, block_entries,
                   rounding_mode="floor")
    nblk = int(nb.sum())
    bg = torch.repeat_interleave(torch.arange(len(nb), device=device), nb,
                                 output_size=nblk)
    k = torch.arange(nblk, device=device) - (torch.cumsum(nb, 0) - nb)[bg]
    e0 = g_e0[bg] + k * block_entries
    e1 = torch.minimum(e0 + block_entries, g_e1[bg])
    g0 = torch.searchsorted(starts, e0, right=True) - 1
    g1 = torch.searchsorted(starts, e1 - 1, right=True)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return ChunkArrays(
        code=code, r=r, rows=rows, vals=vals, seg_start=i32(seg_start),
        seg_x=i32(seg_x), seg_y=i32(window * W),
        blocks=i32(torch.stack([e0, e1, g0, g1], 1)),
        max_segments=int((g1 - g0).max()) if nblk else 0)


class ChunkedSpMV:
    """Chunked SpMV over a fixed layout. Same call surface as the JAX
    engine: `__call__(x, mask, mask_type)`."""

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
        self.out_len = layout.num_window_groups * GROUP_ROWS
        t0 = time.perf_counter()
        self.arrays = chunk_entries(layout, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0   # the derived form's
        self.col_order = layout.step_touch is not None   # SpMSpV's layout
        self.launches = _build.Launches("chunked",
                                        ("chunked", "chunked_pred"))
        self.next_inits = 0   # no call here sets up a next output
        self._plain_index = None

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A (x) x over all nwgrp*1024 rows, before clamp and mask."""
        x = self._check_x(x)
        if not x.is_cuda:
            return self.spmv_plain(x)
        with self.launches("chunked"):
            return self._launch(x, None, "glt_chunked_spmv")

    def _check_x(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1)
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("x: need a contiguous float32 tensor")
        if x.numel() != self.num_cols:
            raise ValueError(f"x: {x.numel()} elements, expected "
                             f"{self.num_cols}")
        if x.device != self.arrays.vals.device:
            raise ValueError(f"x on {x.device}, engine arrays on "
                             f"{self.arrays.vals.device}")
        return x

    def _launch(self, x: torch.Tensor, act: torch.Tensor | None,
                name: str) -> torch.Tensor:
        """Fill y with the semiring zero and launch the kernel (K7p when
        `act` is given) on the current stream."""
        a = self.arrays
        y = torch.full((self.out_len,), self.semiring.zero,
                       dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.blocks, a.seg_start, a.seg_x,
                                       a.seg_y, a.r, a.rows, a.vals, x, y)]
        if act is not None:
            ptrs.append(act.data_ptr())
        _build.launch(name, *ptrs, a.blocks.shape[0], a.max_segments,
                      int(self.semiring.op), float(self.semiring.zero),
                      torch.cuda.current_stream(x.device).cuda_stream)
        return y

    # ---- K7p: SpMSpV over the active column tiles ------------------------
    def tile_activity(self, x: torch.Tensor) -> torch.Tensor:
        """(nct,) uint8: column tiles holding an entry != the semiring
        zero."""
        return (x.reshape(self.nct, C) != self.semiring.zero).any(1).to(
            torch.uint8)

    def active_chunks(self, act: torch.Tensor) -> torch.Tensor:
        """(nchunk,) bool: the layout's chunks of active tiles."""
        return act.bool()[self.arrays.code % self.nct]

    def kept_batches(self, act: torch.Tensor) -> torch.Tensor:
        """(nchunk/32,) bool: the batches holding an active chunk, JAX's
        `touch @ act > 0` (the Pallas kernel's step list)."""
        return self.active_chunks(act).view(-1, CB).any(1)

    def spmv_predicated(self, x: torch.Tensor,
                        act: torch.Tensor) -> torch.Tensor:
        """K7p: y = A (x) x over the entries of active tiles, the semiring
        zero elsewhere; equal to `spmv(x)` when x is the semiring zero
        outside the active tiles."""
        x = self._check_x(x)
        if not x.is_cuda:
            return self.spmv_predicated_plain(x, act)
        if act.dtype != torch.uint8 or act.numel() != self.nct \
                or not act.is_contiguous() or act.device != x.device:
            raise ValueError(f"act: need a contiguous ({self.nct},) uint8 "
                             f"tensor on {x.device}")
        with self.launches("chunked_pred"):
            return self._launch(x, act, "glt_chunked_spmv_predicated")

    def spmv_predicated_plain(self, x: torch.Tensor,
                              act: torch.Tensor) -> torch.Tensor:
        """K7p's plain version: `spmv_plain` over the entries of active
        tiles only."""
        col, _ = self.plain_index()
        return self._plain(x, act.bool()[col // C])

    def plain_index(self):
        """(col, row) of every real entry, int64, expanded once from the
        segments' offsets and the entries' lane and row bytes."""
        if self._plain_index is None:
            a = self.arrays
            counts = (a.seg_start[1:] - a.seg_start[:-1]).long()
            seg = torch.repeat_interleave(
                torch.arange(len(counts), device=counts.device), counts,
                output_size=a.r.numel())
            self._plain_index = (a.seg_x.long()[seg] + a.r.long(),
                                 a.seg_y.long()[seg] + a.rows.long())
        return self._plain_index

    def spmv_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain version: gather, semiring product, then
        `scatter_reduce_` (sum, or amin for ADDMIN) into a y filled with
        the semiring zero, over the real entries."""
        return self._plain(x, None)

    def _plain(self, x: torch.Tensor, keep: torch.Tensor | None):
        col, row = self.plain_index()
        vals = self.arrays.vals
        if keep is not None:
            col, row, vals = col[keep], row[keep], vals[keep]
        g = self.semiring.mul(vals, x.reshape(-1)[col])
        y = torch.full((self.out_len,), self.semiring.zero,
                       dtype=torch.float32, device=x.device)
        reduce = "amin" if self.semiring.op == OpType.ADDMIN else "sum"
        return y.scatter_reduce_(0, row, g, reduce, include_self=True)

    def __call__(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                 mask_type: MaskType | None = None,
                 epilogue: bool = True) -> torch.Tensor:
        """One SpMV, y = mask(A (x) x), (num_rows,); `epilogue=False`, as
        the router engine's: the first num_rows unclamped and unmasked."""
        return self._epilogue(self.spmv(x), mask, mask_type, epilogue)

    def call_predicated(self, x: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        mask_type: MaskType | None = None,
                        epilogue: bool = True) -> torch.Tensor:
        """One SpMSpV on a dense frontier (inactive = the semiring zero):
        `__call__`'s result, through K7p over the active tiles' entries."""
        y = self.spmv_predicated(x, self.tile_activity(x))
        return self._epilogue(y, mask, mask_type, epilogue)

    def _epilogue(self, y, mask, mask_type, epilogue: bool = True):
        """The ANDOR 0/1 clamp and the SpMV mask on the first num_rows
        (neither with `epilogue=False`)."""
        mt = self.mask_type if mask_type is None else mask_type
        y = y[:self.num_rows]
        if not epilogue:
            return y
        if self.semiring.op == OpType.ANDOR:
            y = (y != 0).to(y.dtype)
        if mask is not None and mt != MaskType.NO_MASK:
            y = apply_mask(y, mask, mt, self.semiring.zero)
        return y
