"""Planar-router SpMV engine: gather -> plane deposits -> region reduce, on
Hopper.

Counterpart of `PlanarSpMV` in graphlily_tpu/ops/router_pallas.py:1562,
over the same `PlanarSpMVLayout` arrays (either package's layout: both are
plain numpy and identical), for the graphs the roll router serves badly:
hypersparse ones, whose (128-column page x region) runs are a handful of
elements. Kernels:

  K4 fused    `fused_spmv` (inherited from RouterSpMV: K1's kernel,
              csrc/router_spmv.cu): gather, product, add into y in one
              pass over the engine's row-sorted element form;
  K4 scatter  `scatter` (csrc/planar_spmv.cu): gather and store into the
              flush stream, over the engine's piece-ordered store form;
  K3 reduce   `reduce` (inherited from RouterSpMV, csrc/router_spmv.cu):
              add the flush stream into y, a block per group of one
              region's flushed chunks (`groups`, ops/router.reduce_groups);
  K5 xperm    `xperm` (csrc/planar_spmv.cu): x's column tiles re-laid for
              a "bucket" layout, x2; no app path launches it.

No kernel reads the layout's streams. At init the engine decodes every
deposited element once (`element_index`: its A-stream element, gather
column, flush-stream position, tile and piece, from the descriptor words,
the triple-run words of io/planar_format.planes_to_triples and the
deposit targets), resolves a "bucket" element's x2 slot to the x column
K5 would copy there (`x_columns`), and derives three forms with
ops/router.router_entries (f32 value and one int32 word an element, one
record a segment, blocks of ENTRIES_PER_BLOCK elements):

  entries        K4 fused's: each region's elements sorted by (row, column,
                 value bits) within windows of 2**FORM_COL_BITS columns;
                 an ANDOR engine drops the value stream where every stored
                 value is nonzero, and keeps it, with its column windows,
                 where one is zero (v != 0 && x != 0 then counts no edge
                 there, as JAX's spmv does);
  pred_entries   K4p fused's tile form: the same in windows of 1,024
                 columns, one column tile each, whose flag is the tile, so
                 K1p's kernel skips a dead tile's segments unread;
  store_entries  K4 scatter's and K4p scatter's: every deposited element
                 in piece order, its word the column within its tile and
                 its slot within the target flush chunk, one segment a
                 piece (x offset its tile, stream offset its target
                 chunk, flag its tile).

The first two hold the matrix's (row, column, value) triples and nothing
of the deal: the "free", "bucket" and PERM-C layouts of one graph give
the same arrays. The store form depends on the deal (stream slots differ
between deals). None of the kernels needs K5. `init_seconds` times the
forms and the region-group table (which the tropical pass 1, whose
int32 stream K3 does not read, does not derive). `__call__` is RouterSpMV's: K4 fused
or K4 scatter -> K3 by the same fused rule (ops/router.FUSED_MAX_Y_BYTES),
then the ANDOR 0/1 clamp and the SpMV mask, as the JAX engine does
(router_pallas.py:1757-1782).
Each wrapper runs its kernel on CUDA tensors and its plain PyTorch
version only when given CPU tensors: the forms' walks
(`fused_entries_plain`, `scatter_entries_plain`), which the tests hold to
the plain versions through the layout (`scatter_plain`; `fused_plain`,
K4 scatter -> K3's plain versions through the flush stream). Each launch
adds one to `launches[name]`.

SpMSpV (`call_predicated`, inherited) runs K4p fused or K4p scatter ->
K3p (`fused_predicated`, `scatter_predicated`). A planar A-chunk mixes
the 8 pages of its column tile, so activity is per 1024-column tile, as
in JAX `PlanarSpMV._normalize_act`.

PERM-C layouts (`planar_deal="permc"`, io/permc_format.py; `permc`)
key phase C by destination lane. The engine re-keys those streams by
stream position once at init (io/permc_format.permc_stream_rows), so the
forms and every plain version run on them unchanged. The split branch
reduces with K11 (`reduce`), which is K3's kernel and region-group table
over those position-keyed rows (counted as `permc_reduce`; a thread per
destination lane summing its runs lost to it, PERF.md §6), or with K11p
(`reduce_predicated`, csrc/permc_spmv.cu), which reads the
destination-lane keys and sums each row's run of a live flushed chunk.
Their plain version is K3's (`reduce_plain`): the same sums, added
through the position-keyed rows. ADDMIN stays refused there, as in JAX.

TPU-only parts of the JAX engine are not carried over: the two
accumulator banks, the looped/unrolled split, the guard batching, the
bf16 value stream, the 16-tile padding of the xperm call, the 3-D output
view, the step compaction and PERM-C's prefix differences.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.planar_format import S, L, planes_to_triples
from ..io.permc_format import permc_stream_rows
from ..io.router_format import CHUNK, deposit_targets
from ..semiring import Semiring, MaskType
from . import _build
from .router import (RouterEntries, RouterSpMV, reduce_groups,
                     resolved_index, router_entries)


# K4 fused's column windows: its form's segments cover 2**col_bits columns
# of x, so a warp's gathers stay close: 16,384 columns (64 KB of x) for a
# form with values, 8,192 for the ANDOR form without, whose 4-byte
# elements leave the gather a larger share; fewer where the row within a
# region needs more of the word's 31 bits. Measured on the pokec stand-in
# only (the fastest of 2**11-2**18, ab_kernels.py, PERF.md §6): the other
# planar graphs, whose x sizes and column spreads differ, take the same
# widths unmeasured
FORM_COL_BITS = 14
FORM_COL_BITS_NO_VALUES = 13
# the tropical pass 1's row form, which the ADDMIN walk reads: 2**13
# columns ran 0.7% faster than 2**14 and 9% faster than 2**15 on the
# pokec stand-in alone (ab_kernels.py --kernels walk, PERF.md §6)
FORM_COL_BITS_ADDMIN = 13
# K4p fused's tile form: windows of one column tile, the activity unit
TILE_COL_BITS = 10


@dataclasses.dataclass
class PlanarArrays:
    """The layout's streams on one device, flattened, plus the host-built
    deposit targets and triple-run words."""

    a_page: torch.Tensor         # (nsteps*cb,) int32
    a_r: torch.Tensor            # (nsteps*cb*1024,) int8
    a_sub: torch.Tensor | None   # (nsteps*cb*1024,) int8; "free" deal only
    a_vals: torch.Tensor         # (nsteps*cb*1024,) float32
    rg: torch.Tensor             # (nsteps, rstep, 2) int32
    tri: torch.Tensor            # (nsteps, dstep, 8) int32 a0|d0<<7|n<<14
    target: torch.Tensor         # (nsteps, dstep) int32
    c_code: torch.Tensor         # (nsteps*f,) int32
    c_hi: torch.Tensor           # (nsteps*f*1024,) int8, by stream position
    c_lo: torch.Tensor           # (nsteps*f*1024,) int8, by stream position
    xperm: torch.Tensor | None   # (ntiles*8*8*128,) int8; "bucket" only
    # PERM-C only, (nsteps*f*1024,) int8 keyed by destination lane: the
    # layout's c_hi, c_end and c_beg, which K11p reads
    c_hi_dest: torch.Tensor | None = None
    c_end: torch.Tensor | None = None
    c_beg: torch.Tensor | None = None


def run_words(tw: np.ndarray, nsteps: int, dstep: int) -> np.ndarray:
    """Triple-run words (nsteps, dmax, 8, 128) regrouped per deposit piece,
    (nsteps, dstep, 8) int32: word [t, p, s] is tw[t, p >> 7, s, p & 127],
    so one piece's 8 words are 32 contiguous bytes."""
    tri = tw.transpose(0, 1, 3, 2).reshape(nsteps, -1, S)
    return np.ascontiguousarray(tri[:, :dstep])


def piece_words(lay) -> np.ndarray:
    """`run_words` of a planar layout: `planes_to_triples(lay)`, or the
    words that already replaced its planes (`lay.triples`, the tropical
    "triples" format)."""
    tw = getattr(lay, "triples", None)
    if tw is None:
        tw = planes_to_triples(lay)
    return run_words(tw, lay.nsteps, lay.dstep)


class PlanarSpMV(RouterSpMV):
    """Planar-router SpMV over a fixed layout. Same call surface as
    RouterSpMV: `__call__(x, mask, mask_type, arrays)`, `scatter(x)`,
    `fused_spmv(x)`, `reduce(stream)`, plus `xperm(x)`."""

    def __init__(self, layout, semiring: Semiring,
                 config: EngineConfig = DEFAULT_CONFIG,
                 mask_type: MaskType = MaskType.NO_MASK):
        lay = layout
        self._init_common(lay, semiring, config, mask_type)
        self.permc = getattr(lay, "c_end", None) is not None
        if self.permc and self.TROPICAL:
            raise ValueError("PERM-C layouts serve MULADD/ANDOR only")
        self.chained = lay.a_sub is not None
        self.num_col_tiles = lay.num_col_tiles
        dev = self._dev
        target = deposit_targets(lay.rg, lay.dstep, lay.f)
        c_hi, c_lo = (permc_stream_rows(lay) if self.permc
                      else (lay.c_hi, lay.c_lo))
        dest_keys = (dict(c_hi_dest=dev(lay.c_hi), c_end=dev(lay.c_end),
                          c_beg=dev(lay.c_beg)) if self.permc else {})
        self.arrays = PlanarArrays(
            a_page=dev(lay.a_page), a_r=dev(lay.a_r),
            a_sub=dev(lay.a_sub) if self.chained else None,
            a_vals=dev(lay.a_vals.astype("float32")),
            rg=dev(lay.rg).reshape(lay.nsteps, lay.rstep, 2),
            tri=dev(piece_words(lay)).reshape(lay.nsteps, lay.dstep, S),
            target=dev(target).reshape(lay.nsteps, lay.dstep),
            c_code=dev(lay.c_code), c_hi=dev(c_hi), c_lo=dev(c_lo),
            xperm=None if self.chained else dev(lay.xperm), **dest_keys)
        self.launches = {"fused": 0, "scatter": 0, "reduce": 0, "xperm": 0,
                         "fused_pred": 0, "scatter_pred": 0, "reduce_pred": 0}
        if self.permc:
            self.launches.update(permc_reduce=0, permc_reduce_pred=0)
        t0 = time.perf_counter()
        idx = resolved_index(self)     # one decode for every form
        self.store_entries = router_entries(           # K4 scatter's
            self, "stream", index=idx)
        cap = 31 - int(self.region_rows - 1).bit_length()
        bits = FORM_COL_BITS_ADDMIN if self.TROPICAL else FORM_COL_BITS
        self.entries = router_entries(                 # K4 fused's
            self, "row", col_bits=min(bits, cap), values=None,
            col_bits_no_values=min(FORM_COL_BITS_NO_VALUES, cap), index=idx)
        self.pred_entries = router_entries(            # K4p fused's
            self, "row", col_bits=TILE_COL_BITS, values=None, index=idx)
        self.groups = (None if self.TROPICAL       # K3's, K11's
                       else reduce_groups(self.arrays.c_code))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0   # the derived forms

    # ---- K5 xperm --------------------------------------------------------------
    def xperm(self, x: torch.Tensor,
              arrays: PlanarArrays | None = None) -> torch.Tensor:
        """x re-laid for a "bucket" layout: x2[t, d, l] = x[t, s, v & 127]
        where xperm[t, s, d, l] = v < 0, else 0. (num_cols,)."""
        a = self.arrays if arrays is None else arrays
        if self.chained:
            raise ValueError("a 'free'-deal layout gathers through a_sub and "
                             "has no xperm planes")
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.xperm_plain(x, a)
        x2 = torch.empty_like(x)
        rc = _build.library().glt_planar_xperm(
            a.xperm.data_ptr(), x.data_ptr(), x2.data_ptr(),
            self.num_col_tiles, torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_planar_xperm")
        self.launches["xperm"] += 1
        return x2

    # ---- K4 scatter ------------------------------------------------------------
    def scatter(self, x: torch.Tensor,
                arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Gather and deposits only: the flush stream, (nsteps, f, 8, 128),
        through the store form."""
        self._own_arrays(arrays)
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_entries_plain(x)
        return self._launch_store(x, None)

    def _launch_store(self, x: torch.Tensor, act: torch.Tensor | None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
        """Launch K4 scatter over `store_entries` (K4p scatter when `act` is
        given) on the current stream. K4 scatter zeroes the stream's
        unfilled lanes itself where the form has `tails`; otherwise, and
        for K4p scatter (whose dead pieces' lanes stay zero), the stream is
        zeroed first. `out`, the stream to write, is that zeroed stream,
        or any stream where K4 scatter zeroes its own."""
        e = self.store_entries
        n = self.nsteps * self.f * CHUNK
        own_zeros = act is None and e.tails is not None
        if out is None:
            out = (torch.empty if own_zeros else torch.zeros)(
                n, dtype=self._stream_dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [t.data_ptr() for t in (e.blocks, e.deps, e.vals, e.idx, x,
                                       out)]
        if act is None:
            name, key = "glt_planar_scatter", "scatter"
            rc = _build.library().glt_planar_scatter(
                *ptrs, e.tails.data_ptr() if own_zeros else None,
                e.blocks.shape[0], e.max_segments, e.col_bits,
                self.nsteps * self.f, self._op, stream)
        else:
            name, key = "glt_planar_scatter_pred", "scatter_pred"
            rc = _build.library().glt_planar_scatter_pred(
                *ptrs, act.data_ptr(), e.blocks.shape[0], e.max_segments,
                e.col_bits, self._op, stream)
        self._raise_on(rc, name)
        self.launches[key] += 1
        return out.view(self.nsteps, self.f, S, L)

    # ---- K11 and K11p: PERM-C phase C ---------------------------------------------
    @property
    def _reduce_key(self) -> str:
        """K11 is K3's kernel over a PERM-C layout's position-keyed rows,
        counted apart."""
        return "permc_reduce" if self.permc else "reduce"

    def reduce_predicated(self, stream: torch.Tensor, live: torch.Tensor,
                          arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Phase C over the live flush chunks only: K3p, or on a PERM-C
        layout K11p (a block per live flushed chunk): each chunk's row
        runs, read through the destination-lane keys, added into y."""
        if not self.permc:
            return super().reduce_predicated(stream, live, arrays)
        a = self.arrays if arrays is None else arrays
        stream = stream.reshape(-1)
        nchunks = self.nsteps * self.f
        if not self._check(stream, nchunks * CHUNK, "stream"):
            return self.reduce_plain(stream, a, live)
        self._check_flags(live, nchunks, "live")
        y = torch.zeros(self.out_len, dtype=torch.float32,
                        device=stream.device)
        ptrs = [t.data_ptr() for t in (a.c_code, stream, a.c_hi_dest,
                                       a.c_end, a.c_beg, y, live)]
        rc = _build.library().glt_permc_reduce_pred(
            *ptrs, nchunks, self.region_rows,
            torch.cuda.current_stream(stream.device).cuda_stream)
        self._raise_on(rc, "glt_permc_reduce_pred")
        self.launches["permc_reduce_pred"] += 1
        return y

    # ---- SpMSpV: tile activity, K4p ---------------------------------------------
    ACT_COLS = 1024   # columns per activity flag: a column tile

    def chunk_units(self, a: PlanarArrays | None = None) -> torch.Tensor:
        """(nsteps*cb,) int64: each A-chunk's activity flag, its tile."""
        arr = self.arrays if a is None else a
        return arr.a_page.long()

    def _deposit_k(self, w1: torch.Tensor) -> torch.Tensor:
        """A-chunk within the step of a planar piece word."""
        return w1 & 0xFF

    def scatter_predicated(self, x: torch.Tensor, act: torch.Tensor,
                           arrays: PlanarArrays | None = None) -> torch.Tensor:
        """K4 scatter over the pieces of active tiles only (K4p scatter):
        the flush stream, (nsteps, f, 8, 128); a dead piece's elements
        stay zero."""
        self._own_arrays(arrays)
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_entries_plain(x, act)
        self._check_flags(act, self.num_act, "act")
        return self._launch_store(x, act)

    def pred_plain_entries(self) -> RouterEntries:
        """K4p fused's plain version walks the form its kernel reads, the
        tile form: each row's products in the order of K4 fused's form
        (by column, then value bits), so on a frontier x the two walks
        agree bit for bit."""
        return self.pred_entries

    # ---- plain PyTorch versions --------------------------------------------------
    def element_index(self, arr: PlanarArrays) -> dict:
        """Every deposited element, decoded from the descriptor words,
        triple-run words and targets (uncached): `src` (its A-stream
        element), `col` (its index into x, or into x2 for "bucket"
        layouts), `dst` (its flush-stream position), `unit` (its chunk's
        tile, the activity flag) and `dep` (its live piece, in slot
        order). `plain_index` adds `row` (RouterSpMV's)."""
        w1 = arr.rg[:, :self.dstep, 0].reshape(-1).long()
        w2 = arr.rg[:, :self.dstep, 1].reshape(-1).long()
        active = w2 > 0
        step = torch.arange(self.nsteps, device=w1.device).repeat_interleave(
            self.dstep)[active]
        w1 = w1[active]
        chunk = step * self.cb + (w1 & 0xFF)
        tgt = arr.target.reshape(-1).long()[active]
        words = arr.tri[step, w1 >> 8].long().reshape(-1)   # (pieces*8,)
        a0, d0, n = words & 127, (words >> 7) & 127, (words >> 14) & 255
        nel = int(n.sum())
        run = torch.repeat_interleave(torch.arange(len(n), device=n.device),
                                      n, output_size=nel)
        off = (torch.arange(nel, device=n.device)
               - (torch.cumsum(n, 0) - n)[run])
        piece, s = run // S, run % S
        base = chunk[piece] * CHUNK + s * L
        el_src = base + ((a0[run] + off) & (L - 1))
        r = arr.a_r[el_src].long()
        sub = arr.a_sub[base + r].long() if self.chained else s
        unit = arr.a_page.long()[chunk[piece]]
        return dict(src=el_src, col=unit * CHUNK + sub * L + r,
                    dst=tgt[piece] * CHUNK + s * L + d0[run] + off,
                    unit=unit, dep=piece)

    def x_columns(self, col: torch.Tensor) -> torch.Tensor:
        """x index of each element whose gather index is `col`: the same
        for "free" and PERM-C layouts; for "bucket" ones, `col` is an x2
        slot (t, d, l), resolved to x[t*1024 + s*128 + (v & 127)] of the
        last plane s with xperm[t, s, d, l] = v < 0, as K5 fills it.
        Raises if an element's slot is filled by no plane."""
        if self.chained:
            return col
        nct = self.num_col_tiles
        pv = self.arrays.xperm.view(nct, S, S * L).long()
        tile = torch.arange(nct, device=col.device)[:, None] * CHUNK
        src = torch.full((nct, S * L), -1, dtype=torch.long,
                         device=col.device)
        for s in range(S):
            src = torch.where(pv[:, s] < 0,
                              tile + s * L + (pv[:, s] & (L - 1)), src)
        out = src.reshape(-1)[col]
        if bool((out < 0).any()):
            raise ValueError("a deposited element reads an x2 slot that no "
                             "xperm plane fills")
        return out

    def xperm_plain(self, x: torch.Tensor,
                    a: PlanarArrays | None = None) -> torch.Tensor:
        """K5's plain version: per source sublane, gather and select; the
        last taking plane wins, as in the Pallas body."""
        arr = self.arrays if a is None else a
        if self.chained:
            raise ValueError("a 'free'-deal layout has no xperm planes")
        nct = self.num_col_tiles
        pv = arr.xperm.view(nct, S, S * L).long()     # [t, s_src, d*128 + l]
        x3 = x.reshape(nct, S, L)
        x2 = torch.zeros(nct, S * L, dtype=x.dtype, device=x.device)
        for s in range(S):
            g = torch.gather(x3[:, s, :], 1, pv[:, s] & (L - 1))
            x2 = torch.where(pv[:, s] < 0, g, x2)
        return x2.reshape(-1)

    def scatter_plain(self, x: torch.Tensor, a: PlanarArrays | None = None,
                      act: torch.Tensor | None = None) -> torch.Tensor:
        """K4 scatter's plain version through the layout, the reference the
        store form is held to: (K5's x2 for "bucket" layouts), gather, then
        index_copy_ into a zeroed flush stream through the targets. With
        `act` (per tile), K4p scatter's: active tiles' pieces only."""
        x = x.reshape(-1)
        xs = x if self.chained else self.xperm_plain(x, a)
        return super().scatter_plain(xs, a, act)

    def scatter_entries_plain(self, x: torch.Tensor,
                              act: torch.Tensor | None = None
                              ) -> torch.Tensor:
        """K4 scatter's walk of its store form, the CPU path: each
        element's product index_copy_'d to its stream position; with `act`
        (per tile), K4p scatter's: the elements of live pieces only."""
        e = self.store_entries
        col, dst, flag = self.entries_index(e)
        vals = e.vals
        if act is not None:
            keep = act.bool()[flag]
            col, dst, vals = col[keep], dst[keep], vals[keep]
        g = self._product(vals, x.reshape(-1)[col])
        stream = torch.zeros(self.nsteps * self.f * CHUNK, dtype=g.dtype,
                             device=x.device)
        return stream.index_copy_(0, dst, g).view(self.nsteps, self.f, S, L)
