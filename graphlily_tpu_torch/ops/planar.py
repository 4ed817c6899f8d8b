"""Planar-router SpMV engine: gather -> plane deposits -> region reduce, on
Hopper.

Counterpart of `PlanarSpMV` in graphlily_tpu/ops/router_pallas.py:1562,
over the same `PlanarSpMVLayout` arrays (either package's layout: both are
plain numpy and identical), for the graphs the roll router serves badly:
hypersparse ones, whose (128-column page x region) runs are a handful of
elements. Kernels, in csrc/planar_spmv.cu unless named otherwise:

  K4 fused    `fused_spmv`: gather, deposit, add into y in one pass;
  K4 scatter  `scatter`: gather and deposit into the flush stream;
  K3 reduce   `reduce` (inherited from RouterSpMV, csrc/router_spmv.cu):
              add the flush stream into y;
  K5 xperm    `xperm`: re-lay x's column tiles for "bucket" layouts
              ("free" layouts gather through a_sub and need no re-layout).

The deposits read each piece's 8 triple-run words instead of its 1 KB
plane (io/planar_format.planes_to_triples; 32 B per piece). `__call__`
is RouterSpMV's: K4 fused or K4 scatter -> K3 by the same fused rule
(ops/router.FUSED_MAX_Y_BYTES), then the ANDOR 0/1 clamp and the SpMV
mask, as the JAX engine does (router_pallas.py:1757-1782). Each wrapper
runs its kernel on CUDA tensors and its plain PyTorch version (`*_plain`)
only when given CPU tensors; each launch adds one to `launches[name]`.

SpMSpV (`call_predicated`, inherited) runs K4p fused or K4p scatter ->
K3p (`fused_predicated`, `scatter_predicated`). A planar A-chunk mixes
the 8 pages of its column tile, so activity is per 1024-column tile, as
in JAX `PlanarSpMV._normalize_act`; K5 runs unpredicated.

PERM-C layouts (`planar_deal="permc"`, io/permc_format.py; `permc`)
key phase C by destination lane. The engine re-keys those streams by
stream position once at init (io/permc_format.permc_stream_rows), so K4
fused, K4p fused, K4 scatter and every plain version run on them
unchanged; the split branch reduces with K11 (`reduce`, or K11p
`reduce_predicated`; csrc/permc_spmv.cu), which reads the destination-
lane keys and sums each row's run of the flushed chunk. K11's plain
version is K3's (`reduce_plain`): the same sums, added through the
position-keyed rows. ADDMIN stays refused there, as in JAX.

TPU-only parts of the JAX engine are not carried over: the two
accumulator banks, the looped/unrolled split, the guard batching, the
bf16 value stream, the 16-tile padding of the xperm call, the 3-D output
view, the step compaction and PERM-C's prefix differences.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.planar_format import S, L, planes_to_triples
from ..io.permc_format import permc_stream_rows
from ..io.router_format import CHUNK, deposit_targets
from ..semiring import Semiring, MaskType
from . import _build
from .router import RouterSpMV


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
    # layout's c_hi, c_end and c_beg, which K11 reads
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

    def _gather_source(self, x: torch.Tensor, a: PlanarArrays) -> torch.Tensor:
        """What K4 gathers from: x itself ("free"), or K5's x2."""
        return x if self.chained else self.xperm(x, a)

    # ---- K4 scatter ------------------------------------------------------------
    @property
    def _stream_dtype(self) -> torch.dtype:
        """float32, or int32 for the tropical engine's ADDMIN encodings."""
        return torch.int32 if self.TROPICAL else torch.float32

    def scatter(self, x: torch.Tensor,
                arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Gather and deposits only: the flush stream, (nsteps, f, 8, 128)."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_plain(x, a)
        xs = self._gather_source(x, a)
        stream = torch.zeros(self.nsteps * self.f * CHUNK,
                             dtype=self._stream_dtype, device=x.device)
        rc = _build.library().glt_planar_scatter(
            *self._stream_ptrs(a), xs.data_ptr(), stream.data_ptr(),
            self.nsteps, self.cb, self.rstep, self.dstep, self._op,
            torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_planar_scatter")
        self.launches["scatter"] += 1
        return stream.view(self.nsteps, self.f, S, L)

    # ---- K4 fused ----------------------------------------------------------------
    def fused_spmv(self, x: torch.Tensor,
                   arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Gather, deposits and reduce in one kernel:
        (nregions*region_rows,) rows."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_plain(x, a)
        xs = self._gather_source(x, a)
        y = torch.zeros(self.out_len, dtype=torch.float32, device=x.device)
        rc = _build.library().glt_planar_fused(
            *self._stream_ptrs(a), a.c_code.data_ptr(), a.c_hi.data_ptr(),
            a.c_lo.data_ptr(), xs.data_ptr(), y.data_ptr(),
            self.nsteps, self.cb, self.rstep, self.dstep, self.region_rows,
            self._and_or, torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_planar_fused")
        self.launches["fused"] += 1
        return y

    # ---- K11 and K11p: PERM-C phase C ---------------------------------------------
    def reduce(self, stream: torch.Tensor,
               arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Phase C of the split branch: K3, or K11 on a PERM-C layout.
        (nregions*region_rows,) rows."""
        if not self.permc:
            return super().reduce(stream, arrays)
        return self._permc_reduce(stream, None, arrays)

    def reduce_predicated(self, stream: torch.Tensor, live: torch.Tensor,
                          arrays: PlanarArrays | None = None) -> torch.Tensor:
        """Phase C over the live flush chunks only: K3p, or K11p on a
        PERM-C layout."""
        if not self.permc:
            return super().reduce_predicated(stream, live, arrays)
        return self._permc_reduce(stream, live, arrays)

    def _permc_reduce(self, stream: torch.Tensor, live: torch.Tensor | None,
                      arrays: PlanarArrays | None) -> torch.Tensor:
        """K11, or K11p with `live`: each flushed chunk's row runs, read
        through the destination-lane keys, added into y."""
        a = self.arrays if arrays is None else arrays
        stream = stream.reshape(-1)
        nchunks = self.nsteps * self.f
        if not self._check(stream, nchunks * CHUNK, "stream"):
            return self.reduce_plain(stream, a, live)
        y = torch.zeros(self.out_len, dtype=torch.float32,
                        device=stream.device)
        ptrs = [t.data_ptr() for t in (a.c_code, stream, a.c_hi_dest,
                                       a.c_end, a.c_beg, y)]
        cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
        if live is None:
            key = "permc_reduce"
            rc = _build.library().glt_permc_reduce(
                *ptrs, nchunks, self.region_rows, cuda_stream)
        else:
            self._check_flags(live, nchunks, "live")
            key = "permc_reduce_pred"
            rc = _build.library().glt_permc_reduce_pred(
                *ptrs, live.data_ptr(), nchunks, self.region_rows,
                cuda_stream)
        self._raise_on(rc, f"glt_{key}")
        self.launches[key] += 1
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
        """K4 scatter over the pieces of active tiles only (K5 first for
        "bucket" layouts): the flush stream, (nsteps, f, 8, 128)."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_plain(x, a, act)
        self._check_flags(act, self.num_act, "act")
        xs = self._gather_source(x, a)
        stream = torch.zeros(self.nsteps * self.f * CHUNK,
                             dtype=self._stream_dtype, device=x.device)
        rc = _build.library().glt_planar_scatter_pred(
            *self._stream_ptrs(a), xs.data_ptr(), stream.data_ptr(),
            act.data_ptr(), self.nsteps, self.cb, self.rstep, self.dstep,
            self._op, torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_planar_scatter_pred")
        self.launches["scatter_pred"] += 1
        return stream.view(self.nsteps, self.f, S, L)

    def fused_predicated(self, x: torch.Tensor, act: torch.Tensor,
                         arrays: PlanarArrays | None = None) -> torch.Tensor:
        """K4 fused over the pieces of active tiles only:
        (nregions*region_rows,) rows."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_plain(x, a, act)
        self._check_flags(act, self.num_act, "act")
        xs = self._gather_source(x, a)
        y = torch.zeros(self.out_len, dtype=torch.float32, device=x.device)
        rc = _build.library().glt_planar_fused_pred(
            *self._stream_ptrs(a), a.c_code.data_ptr(), a.c_hi.data_ptr(),
            a.c_lo.data_ptr(), xs.data_ptr(), y.data_ptr(), act.data_ptr(),
            self.nsteps, self.cb, self.rstep, self.dstep, self.region_rows,
            self._and_or, torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_planar_fused_pred")
        self.launches["fused_pred"] += 1
        return y

    @staticmethod
    def _stream_ptrs(a: PlanarArrays) -> list:
        """K4's leading pointer arguments; a null a_sub selects the
        "bucket" gather."""
        sub = a.a_sub.data_ptr() if a.a_sub is not None else None
        return [a.a_page.data_ptr(), a.a_r.data_ptr(), sub,
                a.a_vals.data_ptr(), a.rg.data_ptr(), a.tri.data_ptr(),
                a.target.data_ptr()]

    # ---- plain PyTorch versions --------------------------------------------------
    def plain_index(self, a: PlanarArrays | None = None) -> dict:
        """Per-element index vectors of the plain versions, expanded once
        from the descriptor words, triple-run words and targets: `src`
        (A-stream element of each deposited nnz), `col` (its index into
        x, or into x2 for "bucket" layouts), `dst` (its flush-stream
        position), `unit` (its chunk's tile, the activity flag) and `row`
        (output row of every flush-stream position; positions of unused
        chunks point one past the end)."""
        own = a is None or a is self.arrays
        if own and self._plain_index is not None:
            return self._plain_index
        arr = self.arrays if a is None else a
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
        el_col = arr.a_page.long()[chunk[piece]] * CHUNK + sub * L + r
        el_dst = tgt[piece] * CHUNK + s * L + d0[run] + off
        idx = dict(src=el_src, col=el_col, dst=el_dst,
                   unit=arr.a_page.long()[chunk[piece]], row=self._rows(arr))
        if own:
            self._plain_index = idx
        return idx

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
        """K4 scatter's plain version: (x2 for "bucket" layouts), gather,
        then index_copy_ into a zeroed flush stream through the targets.
        With `act` (per tile), K4p scatter's: active tiles' pieces only."""
        x = x.reshape(-1)
        xs = x if self.chained else self.xperm_plain(x, a)
        return super().scatter_plain(xs, a, act)
