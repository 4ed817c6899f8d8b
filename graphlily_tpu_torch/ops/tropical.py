"""Tropical (min-plus) SpMV engine on Hopper: one ADDMIN walk of the planar
pass 1's row-sorted form; the TPU's three passes (planar pass 1 -> window
split -> window reduce) kept as its stages.

Counterpart of `TropicalSpMV` in graphlily_tpu/ops/tropical_pallas.py:435,
over the same `TropicalSpMVLayout` (io/tropical_format.py; either
package's layout: both are plain numpy and identical). The ladder sends
SSSP here where the chunked layout is infeasible (module/spmv_module.
resolve_engine).

One SpMV (`__call__`) is one walk, `fused`: K1's kernel in ADDMIN mode
(csrc/router_spmv.cu, K4 fused's instance) over the pass-1 engine's row
form `entries` (every element with its value, sorted by row within each
region and window of 2**FORM_COL_BITS_ADDMIN columns, ops/planar.py):
each product's exact int32 encoding E = INF_BITS - bits(min(val + x,
FLOAT_INF)) (semiring.tropical_encode, csrc/semiring_product.cuh),
folded by row with int32 max and one atomicMax a run into a zeroed out,
K10's own reduction. The int32 max is exact in any order, so `out` is
bit-equal to the three passes' on every x, negative entries and F2's
clipped weights included (ROADMAP queue 3 F2 is the reference's fault,
and the walk keeps the port equal to it). SpMSpV (`call_predicated`) is the
predicated walk, `fused_predicated` (K1p's kernel) over the tile form
`pred_entries` (windows of one 1,024-column tile, each segment flagged
by its tile, the activity unit): a dead tile's elements are not read.
Their plain version (`fused_plain`, the CPU path) is scatter_reduce_
amax of the encodings over the form. Each launch counts as `fused` or
`fused_pred`.

The three passes stay as the engine's stages, held to their plain
versions and to the walk; no app path launches them. They are the JAX
pipeline (tropical_pallas.py:513-564):

  K4 scatter  pass 1 in ADDMIN mode (csrc/planar_spmv.cu, over the pass-1
              engine's piece-ordered store form, which resolves a "bucket"
              element's x2 slot to its x column, so K5 never runs):
              every product's exact int32 encoding
              E = INF_BITS - bits(min(val + x, FLOAT_INF))
              (semiring.tropical_encode) into a zeroed region-major flush
              stream g1, whose zeros are E(FLOAT_INF), the identity of max;
              K4p scatter over the pieces of active tiles for SpMSpV;
  K8 / K9     `split` (csrc/tropical_spmv.cu): g1, read through `in_order`,
              into the window-pure chunks of the compact window stream g2,
              from the deposit planes (K8, split format "planes") or the
              sort planes and run words (K9, "triples");
  K10         `window_reduce`: the int32 max of every window row into
              out[num_windows * 128];

then y = bits^-1(INF_BITS - out) and the SpMV mask, as torch ops (after
the walk too). The walk's out has the pass-1 regions' rows (out_len),
K10's the windows' (num_windows * 128): both index global rows, window w
holding rows 128w..128w+127, and init checks that the regions cover
the windows, so K10's out is a prefix of the walk's and the rows past it
hold 0. Pass 1 is a PlanarSpMV in ADDMIN mode (`TropicalPass1`) that
derives the row, tile and store forms and shares this engine's
`launches`.

The TPU kernels carry digit accumulators from grid step to grid step. Here
the host resolves, once, the window chunk each split deposit is flushed
into (io/router_format.deposit_targets with the block map qblk2), so K8
and K9 are independent copies. Each wrapper runs its kernel on CUDA
tensors and its plain PyTorch version (`*_plain`: index copies expanded
from the descriptors or the pieces, `scatter_reduce_` amax) only when
given CPU tensors; each launch adds one to `launches[name]`.

K8 does not read the deposit planes (1 KB a piece, a byte a lane, almost
all empty). At init the engine derives from them, on the device, its
compact form (`split_pieces`): for each live piece its source and target
chunks and first element, one run word per sublane (each (piece,
sublane) moves one contiguous destination run: d0 << 7 | n << 14, the
word format of csrc/piece_runs.cuh with a0 unused), and one source-lane
byte per moved element. The planes then leave the device; `init_seconds`
times the form.

x must be >= 0 (distances): padding A-slots hold FLOAT_INF, the tropical
annihilator, and the encoding orders only non-negative floats. SpMSpV
(`call_predicated`) flags a column tile active where any x differs from
FLOAT_INF, the semiring zero (not where x != 0: a source sits at distance
0). The JAX engine's `out_3d` view, accumulator banks, looped split and
guard batching are TPU-only and not carried over.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.planar_format import S, L
from ..io.router_format import CHUNK, deposit_targets
from ..semiring import (Semiring, OpType, MaskType, apply_mask, FLOAT_INF,
                        tropical_decode)
from . import _build
from .planar import PlanarSpMV, run_words


class TropicalPass1(PlanarSpMV):
    """The planar pass 1 in ADDMIN mode. K4 fused's walk (`fused_spmv`,
    `fused_predicated`) writes the int32 max of the encodings by row over
    its row and tile forms; K4 scatter and K4p scatter write the
    encodings into the flush stream over its store form. K3 refuses the
    int32 stream, so the walk's reference is the three passes
    (TropicalSpMV.scatter, split, window_reduce), not `fused_plain`."""

    TROPICAL = True

    def fused_plain(self, *args, **kwargs):
        raise ValueError("K3 adds floats: the tropical walk's reference is "
                         "TropicalSpMV.window_reduce(split(scatter(x)))")

    def reduce(self, *args, **kwargs):
        raise ValueError("K3 adds floats: the tropical pass 1's stream goes "
                         "to TropicalSpMV.split, then window_reduce")


@dataclasses.dataclass
class SplitPieces:
    """K8's compact form of the deposit planes (`split_pieces`): the live
    pieces in descriptor-slot order."""

    pieces: torch.Tensor   # (P, 4) int32: source chunk of g1 (through
                           # in_order), target chunk of g2, first element
                           # in `lanes`, 0
    runs: torch.Tensor     # (P, 8) int32: d0 << 7 | n << 14 per sublane
    lanes: torch.Tensor    # (N,) uint8: source lane of each moved element,
                           # piece-major, then sublane, then destination

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.pieces, self.runs, self.lanes))


def split_pieces(rg2: torch.Tensor, planes2: torch.Tensor,
                 in_order: torch.Tensor, target2: torch.Tensor, kb: int,
                 dstep2: int) -> SplitPieces:
    """K8's compact form, with torch ops on the planes' device: every plane
    entry v < 0 of a live piece (rg2 w2 > 0; plane w1 >> 8 of its step)
    moves g1[in_order[t*kb + (w1 & 0xFF)]][s, v & 127] to
    g2[target2[t, j]][s, l]. Raises unless each (piece, sublane) moves one
    contiguous run of destination lanes."""
    nsteps2 = rg2.shape[0]
    t, j = torch.nonzero(rg2[:, :dstep2, 1] > 0, as_tuple=True)
    w1 = rg2[t, j, 0].long()
    planes = planes2.view(nsteps2, -1, CHUNK)
    piece, e = torch.nonzero(planes[t, w1 >> 8] < 0, as_tuple=True)
    lanes = (planes[t[piece], (w1 >> 8)[piece], e] & (L - 1)).to(torch.uint8)
    npieces = len(t)
    run = piece * S + e // L                    # (piece, sublane) of each
    lane = e % L
    n = torch.bincount(run, minlength=npieces * S)
    d0 = torch.full((npieces * S,), L, dtype=torch.int64, device=e.device)
    d0.scatter_reduce_(0, run, lane, "amin")
    last = torch.full_like(d0, -1).scatter_reduce_(0, run, lane, "amax")
    if not bool(((n == 0) | (last - d0 + 1 == n)).all()):
        raise ValueError("a split piece's destination lanes are not a run")
    d0 = torch.where(n > 0, d0, 0)
    count = n.view(npieces, S).sum(1)
    first = torch.cumsum(count, 0) - count
    src = in_order.long()[t * kb + (w1 & 0xFF)]
    i32 = lambda a: a.to(torch.int32).contiguous()
    return SplitPieces(
        pieces=i32(torch.stack([src, target2[t, j].long(), first,
                                torch.zeros_like(first)], 1)),
        runs=i32((d0 << 7 | n << 14).view(npieces, S)), lanes=lanes)


@dataclasses.dataclass
class TropicalArrays:
    """The split and reduce streams on one device, flattened, plus the
    host-built split targets. Pass 1's are its PlanarArrays."""

    in_order: torch.Tensor         # (nsteps2*kb,) int32
    rg2: torch.Tensor              # (nsteps2, rstep2, 2) int32
    target2: torch.Tensor          # (nsteps2, dstep2) int32
    split: SplitPieces | None      # K8's form of the planes; "planes"
    xsort2: torch.Tensor | None    # (nsteps2*kb*1024,) int32; "triples"
    tri2: torch.Tensor | None      # (nsteps2, dstep2, 8) int32; "triples"
    c_win: torch.Tensor            # (nchunks2,) int32
    sort2: torch.Tensor            # (nchunks2*1024,) int8
    rowids: torch.Tensor           # (nchunks2*1024,) int8


class TropicalSpMV:
    """Tropical SpMV over a fixed layout: `__call__(x, mask, mask_type)`
    and `call_predicated(x, mask, mask_type)` through the walk (`fused`,
    `fused_predicated`), and the three-pass stages `scatter`, `split`,
    `window_reduce`."""

    ACT_COLS = 1024   # columns per activity flag: a column tile

    def __init__(self, layout, semiring: Semiring,
                 config: EngineConfig = DEFAULT_CONFIG,
                 mask_type: MaskType = MaskType.NO_MASK):
        if semiring.op != OpType.ADDMIN:
            raise ValueError("the tropical engine runs ADDMIN only; "
                             "PlanarSpMV and RouterSpMV run MULADD/ANDOR")
        lay = layout
        self.planar = TropicalPass1(lay.planar, semiring, config)
        self.semiring = semiring
        self.mask_type = mask_type
        self.num_rows, self.num_cols = lay.num_rows, lay.num_cols
        self.num_col_tiles = lay.num_col_tiles
        self.nnz = lay.nnz
        self.num_windows = lay.num_windows
        self.kb, self.f2 = lay.kb, lay.f2
        self.nsteps2, self.rstep2 = lay.nsteps2, lay.rstep2
        self.dstep2 = lay.dstep2
        self.nchunks2 = len(lay.c_win)           # window-stream chunks
        self.triples = lay.triples2 is not None
        if int(lay.c_win.max(initial=-1)) >= self.num_windows:
            raise ValueError("a window chunk names a window past the rows")
        if self.num_windows * L > self.planar.out_len:
            raise ValueError("the windows' rows pass the pass-1 regions': "
                             "the walk's out would not hold K10's")
        dev = self.planar._dev
        target2 = deposit_targets(lay.rg2, lay.dstep2, lay.f2,
                                  block=lay.qblk2)
        rg2 = dev(lay.rg2).reshape(lay.nsteps2, lay.rstep2, 2)
        target2 = dev(target2).reshape(lay.nsteps2, lay.dstep2)
        in_order = dev(lay.in_order)
        t0 = time.perf_counter()
        split = None if self.triples else split_pieces(
            rg2, dev(lay.planes2), in_order, target2, lay.kb, lay.dstep2)
        if self.planar.device.type == "cuda":
            torch.cuda.synchronize(self.planar.device)
        self.init_seconds = time.perf_counter() - t0   # K8's form
        self.arrays = TropicalArrays(
            in_order=in_order, rg2=rg2, target2=target2, split=split,
            xsort2=dev(lay.xsort2) if self.triples else None,
            tri2=(dev(run_words(lay.triples2, lay.nsteps2, lay.dstep2))
                  .reshape(lay.nsteps2, lay.dstep2, S)
                  if self.triples else None),
            c_win=dev(lay.c_win), sort2=dev(lay.sort2),
            rowids=dev(lay.rowids))
        self.launches = {"fused": 0, "fused_pred": 0, "xperm": 0,
                         "scatter": 0, "scatter_pred": 0, "split": 0,
                         "split_triples": 0, "window_reduce": 0}
        self.planar.launches = self.launches
        self._split_index = None
        self._reduce_index = None

    # ---- argument checks ---------------------------------------------------
    def _check_stream(self, t: torch.Tensor, numel: int, what: str) -> bool:
        """Validate an int32 stream; True when the kernel runs (CUDA)."""
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: need a contiguous int32 tensor")
        if t.numel() != numel:
            raise ValueError(f"{what}: {t.numel()} elements, expected {numel}")
        if t.device != self.arrays.c_win.device:
            raise ValueError(f"{what} on {t.device}, engine arrays on "
                             f"{self.arrays.c_win.device}")
        return t.is_cuda

    @property
    def g1_numel(self) -> int:
        p = self.planar
        return p.nsteps * p.f * CHUNK

    # ---- the walk: K4 fused and K4p fused (ADDMIN) ----------------------------
    def fused(self, x: torch.Tensor) -> torch.Tensor:
        """out, (out_len,) int32: the max encoding of every row, in one
        walk of the row form (K1's kernel in ADDMIN mode); 0 for a row
        with no entry."""
        return self.planar.fused_spmv(x)

    def fused_predicated(self, x: torch.Tensor,
                         act: torch.Tensor) -> torch.Tensor:
        """out over the elements of active tiles only, one walk of the
        tile form (K1p's kernel in ADDMIN mode)."""
        return self.planar.fused_predicated(x, act)

    def fused_plain(self, x: torch.Tensor,
                    act: torch.Tensor | None = None) -> torch.Tensor:
        """The walk's plain version: scatter_reduce_ amax of every
        element's encoding into a zeroed out at its row, over the row form
        (the tile form's active tiles with `act`)."""
        p = self.planar
        form = p.entries if act is None else p.pred_entries
        return p.fused_entries_plain(x.reshape(-1), act, form)

    # ---- pass 1: K4 scatter and K4p scatter (ADDMIN) ------------------------
    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 flush stream g1, (nsteps, f, 8, 128)."""
        return self.planar.scatter(x)

    def scatter_predicated(self, x: torch.Tensor,
                           act: torch.Tensor) -> torch.Tensor:
        """g1 over the pieces of active tiles only; the others stay 0."""
        return self.planar.scatter_predicated(x, act)

    def scatter_plain(self, x: torch.Tensor,
                      act: torch.Tensor | None = None) -> torch.Tensor:
        """K4 scatter's plain version (K4p scatter's with `act`)."""
        return self.planar.scatter_plain(x, None, act)

    def activity(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 frontier activity, one flag per column tile: any x there
        other than FLOAT_INF, the semiring zero."""
        return (x.reshape(-1, self.ACT_COLS) != float(FLOAT_INF)).any(1).to(
            torch.uint8)

    # ---- K8 / K9 split -------------------------------------------------------
    def split(self, g1: torch.Tensor) -> torch.Tensor:
        """g1 into the window stream g2, (nchunks2, 8, 128) int32: K8 over
        the planes' compact form, or K9 over the sort planes and run
        words."""
        a = self.arrays
        g1 = g1.reshape(-1)
        if not self._check_stream(g1, self.g1_numel, "g1"):
            return self.split_plain(g1)
        g2 = torch.zeros(self.nchunks2 * CHUNK, dtype=torch.int32,
                         device=g1.device)
        stream = torch.cuda.current_stream(g1.device).cuda_stream
        lib = _build.library()
        if self.triples:
            name = "split_triples"
            rc = lib.glt_tropical_split_triples(
                a.rg2.data_ptr(), a.tri2.data_ptr(), a.xsort2.data_ptr(),
                a.in_order.data_ptr(), a.target2.data_ptr(), g1.data_ptr(),
                g2.data_ptr(), self.nsteps2, self.kb, self.rstep2,
                self.dstep2, stream)
        else:
            name = "split"
            p = a.split
            rc = lib.glt_tropical_split(
                p.pieces.data_ptr(), p.runs.data_ptr(), p.lanes.data_ptr(),
                g1.data_ptr(), g2.data_ptr(), p.pieces.shape[0], stream)
        self.planar._raise_on(rc, f"glt_tropical_{name}")
        self.launches[name] += 1
        return g2.view(self.nchunks2, S, L)

    # ---- K10 window reduce ---------------------------------------------------
    def window_reduce(self, g2: torch.Tensor) -> torch.Tensor:
        """The window max of g2: out, (num_windows * 128,) int32 encodings
        (0, E(FLOAT_INF), for a row with no entry)."""
        a = self.arrays
        g2 = g2.reshape(-1)
        if not self._check_stream(g2, self.nchunks2 * CHUNK, "g2"):
            return self.window_reduce_plain(g2)
        out = torch.zeros(self.num_windows * L, dtype=torch.int32,
                          device=g2.device)
        rc = _build.library().glt_tropical_window_reduce(
            a.c_win.data_ptr(), g2.data_ptr(), a.sort2.data_ptr(),
            a.rowids.data_ptr(), out.data_ptr(), self.nchunks2,
            torch.cuda.current_stream(g2.device).cuda_stream)
        self.planar._raise_on(rc, "glt_tropical_window_reduce")
        self.launches["window_reduce"] += 1
        return out

    # ---- plain PyTorch versions ----------------------------------------------
    def split_index(self) -> dict:
        """Per-element index vectors of the split's plain version, expanded
        once from the pieces' run words (K9: the descriptor words, padding
        slots skipped): `src` (g1 position of each moved element) and `dst`
        (its g2 position)."""
        if self._split_index is not None:
            return self._split_index
        a = self.arrays
        if not self.triples:
            self._split_index = self._pieces_index(a.split)
            return self._split_index
        w1 = a.rg2[:, :self.dstep2, 0].long()
        t, j = torch.nonzero(a.rg2[:, :self.dstep2, 1] > 0, as_tuple=True)
        w1 = w1[t, j]
        pos = t * self.kb + (w1 & 0xFF)
        chunk = a.in_order.long()[pos]
        tgt = a.target2.long()[t, j]
        words = a.tri2[t, w1 >> 8].long().reshape(-1)   # (pieces*8,)
        a0, d0, n = words & 127, (words >> 7) & 127, (words >> 14) & 255
        nel = int(n.sum())
        run = torch.repeat_interleave(
            torch.arange(len(n), device=n.device), n, output_size=nel)
        off = (torch.arange(nel, device=n.device)
               - (torch.cumsum(n, 0) - n)[run])
        piece, s = run // S, run % S
        sorted_lane = (a0[run] + off) & (L - 1)
        lane = a.xsort2.long()[pos[piece] * CHUNK + s * L + sorted_lane]
        src = chunk[piece] * CHUNK + s * L + lane
        dst = tgt[piece] * CHUNK + s * L + d0[run] + off
        self._split_index = dict(src=src, dst=dst)
        return self._split_index

    @staticmethod
    def _pieces_index(p: SplitPieces) -> dict:
        """`src` and `dst` of every element of K8's form: run r = (piece,
        sublane s) moves lanes[first + ...] of sublane s to lanes d0 + i."""
        words = p.runs.long().reshape(-1)
        d0, n = (words >> 7) & 127, (words >> 14) & 255
        nel = p.lanes.numel()
        run = torch.repeat_interleave(torch.arange(len(n), device=n.device),
                                      n, output_size=nel)
        off = (torch.arange(nel, device=n.device)
               - (torch.cumsum(n, 0) - n)[run])
        piece, s = run // S, run % S
        src = (p.pieces[:, 0].long()[piece] * CHUNK + s * L
               + p.lanes.long())
        dst = p.pieces[:, 1].long()[piece] * CHUNK + s * L + d0[run] + off
        return dict(src=src, dst=dst)

    def split_plain(self, g1: torch.Tensor) -> torch.Tensor:
        """K8's and K9's plain version: index_copy_ of g1's elements into
        a zeroed window stream."""
        idx = self.split_index()
        g2 = torch.zeros(self.nchunks2 * CHUNK, dtype=torch.int32,
                         device=g1.device)
        g2.index_copy_(0, idx["dst"], g1.reshape(-1)[idx["src"]])
        return g2.view(self.nchunks2, S, L)

    def reduce_index(self) -> dict:
        """Index vectors of K10's plain version, over every slot of the
        chunks with a window: `src` (the g2 element the sorted slot reads)
        and `row` (its output row)."""
        if self._reduce_index is not None:
            return self._reduce_index
        a = self.arrays
        cw = a.c_win.long()
        live = torch.nonzero(cw >= 0, as_tuple=True)[0]
        slot = (live[:, None] * CHUNK
                + torch.arange(CHUNK, device=live.device)).reshape(-1)
        sub = (slot // L) * L                # the slot's sublane row in g2
        src = sub + a.sort2[slot].long()
        row = cw[live].repeat_interleave(CHUNK) * L + a.rowids[slot].long()
        self._reduce_index = dict(src=src, row=row)
        return self._reduce_index

    def window_reduce_plain(self, g2: torch.Tensor) -> torch.Tensor:
        """K10's plain version: scatter_reduce_ amax of the sorted slots
        into a zeroed out."""
        idx = self.reduce_index()
        out = torch.zeros(self.num_windows * L, dtype=torch.int32,
                          device=g2.device)
        out.scatter_reduce_(0, idx["row"], g2.reshape(-1)[idx["src"]], "amax")
        return out

    # ---- SpMV and SpMSpV -------------------------------------------------------
    def __call__(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                 mask_type: MaskType | None = None) -> torch.Tensor:
        """One SpMV, y = mask(A (min,+) x), (num_rows,): the walk."""
        return self._finish(self.fused(x), mask, mask_type)

    def call_predicated(self, x: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        mask_type: MaskType | None = None) -> torch.Tensor:
        """One SpMSpV on a dense frontier (x = FLOAT_INF off the frontier):
        `__call__`'s result, through the walk of the active tiles."""
        return self._finish(self.fused_predicated(x, self.activity(x)),
                            mask, mask_type)

    def _finish(self, out, mask, mask_type) -> torch.Tensor:
        """Decode and the SpMV mask."""
        y = tropical_decode(out)[:self.num_rows]
        mt = self.mask_type if mask_type is None else mask_type
        if mask is not None and mt != MaskType.NO_MASK:
            y = apply_mask(y, mask, mt, self.semiring.zero)
        return y
