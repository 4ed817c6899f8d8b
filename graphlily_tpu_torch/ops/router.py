"""Roll-router SpMV engine: gather -> deposit -> region reduce, on Hopper.

Counterpart of `RouterSpMV` in graphlily_tpu/ops/router_pallas.py:1816,
over the same `RouterSpMVLayout` arrays (either package's layout: both
are plain numpy and identical). Three CUDA kernels in
csrc/router_spmv.cu carry it:

  K1 fused    `fused_spmv`: gather, deposit, add into y in one pass;
  K2 scatter  `scatter`: gather and deposit into the flush stream;
  K3 reduce   `reduce`: add the flush stream into y.

`__call__` runs K1 or K2 -> K3 by the `fused` rule below, then the ANDOR
0/1 clamp and the SpMV mask, as the JAX engine does. Each wrapper runs its
kernel on CUDA tensors, and its plain PyTorch version (`*_plain`, same
contract: gather, `index_copy_` into a zeroed flush stream through the
deposit targets, `index_add_` into y) only when given CPU tensors. Each
kernel launch adds one to `launches[name]`.

SpMSpV (`call_predicated`, JAX `__call__(tiles_active=, fidx=)`) runs the
frontier-predicated forms K1p, K2p -> K3p (`*_predicated`, counted as
`fused_pred`, `scatter_pred`, `reduce_pred`). Activity is per 128-column
page (`activity`; a roll A-chunk holds one page). A deposit whose chunk's
page is inactive gathers only zeros and is skipped; K3p skips the flush
chunks that no live deposit targets (`live_chunks`, scattered on the
device from the deposit targets). That is the keep-set of JAX
`_predicate_rg` and `_predicate_exact` without the host flush index: every
deposit already knows its flush chunk. Nothing is read back to the host.
Their plain versions are the plain versions above with the plain index
filtered by chunk activity.

`PlanarSpMV` (ops/planar.py) inherits the argument checks, K3 and K3p, the
fused rule, the live sets and `__call__`/`call_predicated`.

TPU-only parts of the JAX engine are not carried over: the 3-D output
view, the flat descriptor layout, the two accumulator banks, the bf16
value stream, the ablation hooks, and the step compaction (`sm`/`na`)
that the in-order Pallas grid needs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import EngineConfig, DEFAULT_CONFIG
from ..io.router_format import CHUNK, deposit_targets
from ..semiring import (Semiring, OpType, MaskType, apply_mask,
                        tropical_encode)
from . import _build

# The fused rule for Hopper. K1 and the K2 -> K3 pair issue the same y
# atomics; the pair also writes and reads back the whole flush stream
# (62 MB on the googleplus stand-in). So K1 wins whenever its atomics stay
# in the 50 MB L2, which holds with room to spare while y fits in half of
# it: every ICCAD graph does (orkut's y is 12 MB). Past that, neither path
# keeps y in L2 and the split pair is taken; which of the two is faster
# there has not been measured.
FUSED_MAX_Y_BYTES = 25 * 2**20


@dataclasses.dataclass
class RouterArrays:
    """The layout's streams on one device, flattened, plus the host-built
    deposit targets (io/router_format.deposit_targets)."""

    a_page: torch.Tensor   # (nsteps*cb,) int32
    a_r: torch.Tensor      # (nsteps*cb*1024,) int8
    a_sub: torch.Tensor    # (nsteps*cb*1024,) int8
    a_vals: torch.Tensor   # (nsteps*cb*1024,) float32
    rg: torch.Tensor       # (nsteps, rstep, 2) int32
    target: torch.Tensor   # (nsteps, dstep) int32
    c_code: torch.Tensor   # (nsteps*f,) int32
    c_hi: torch.Tensor     # (nsteps*f*1024,) int8
    c_lo: torch.Tensor     # (nsteps*f*1024,) int8


class RouterSpMV:
    """Router SpMV over a fixed layout. Same call surface as the JAX
    engine: `__call__(x, mask, mask_type, arrays)` and `scatter(x)`."""

    TROPICAL = False   # the ADDMIN engine (ops/tropical.py) sets it

    def __init__(self, layout, semiring: Semiring,
                 config: EngineConfig = DEFAULT_CONFIG,
                 mask_type: MaskType = MaskType.NO_MASK):
        self._init_common(layout, semiring, config, mask_type)
        lay = layout
        dev = self._dev
        target = deposit_targets(lay.rg, lay.dstep, lay.f)
        self.arrays = RouterArrays(
            a_page=dev(lay.a_page), a_r=dev(lay.a_r), a_sub=dev(lay.a_sub),
            a_vals=dev(lay.a_vals.astype("float32")),
            rg=dev(lay.rg).reshape(lay.nsteps, lay.rstep, 2),
            target=dev(target).reshape(lay.nsteps, lay.dstep),
            c_code=dev(lay.c_code), c_hi=dev(lay.c_hi), c_lo=dev(lay.c_lo))
        self.launches = {"fused": 0, "scatter": 0, "reduce": 0,
                         "fused_pred": 0, "scatter_pred": 0, "reduce_pred": 0}

    def _init_common(self, lay, semiring: Semiring, config: EngineConfig,
                     mask_type: MaskType) -> None:
        """What every flush-stream engine shares: checks, sizes, the fused
        rule and the plain versions' index cache."""
        if self.TROPICAL != (semiring.op == OpType.ADDMIN):
            raise ValueError("the tropical engine runs ADDMIN only"
                             if self.TROPICAL else
                             "router engine supports MULADD/ANDOR only")
        if config.dtype != "float32":
            raise ValueError("the router kernels compute in float32 only")
        self.semiring = semiring
        self.mask_type = mask_type
        self.device = config.resolve_device()
        self.num_rows, self.num_cols = lay.num_rows, lay.num_cols
        self.nsteps, self.cb, self.f = lay.nsteps, lay.cb, lay.f
        self.rstep, self.dstep = lay.rstep, lay.dstep
        self.region_rows, self.num_regions = lay.region_rows, lay.num_regions
        self.nnz, self.num_slots = lay.nnz, lay.num_slots
        self.out_len = self.num_regions * self.region_rows
        self.fused = self.out_len * 4 <= FUSED_MAX_Y_BYTES
        self._plain_index = None
        self._deposits = None

    def _dev(self, a) -> torch.Tensor:
        """A layout array, flattened, on the engine's device."""
        return torch.from_numpy(a).reshape(-1).to(self.device)

    # ---- argument checks ---------------------------------------------------
    def _check(self, t: torch.Tensor, numel: int, what: str) -> bool:
        """Validate a vector argument; True when the kernel runs (CUDA)."""
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: need a contiguous float32 tensor")
        if t.numel() != numel:
            raise ValueError(f"{what}: {t.numel()} elements, expected {numel}")
        if t.device != self.arrays.a_vals.device:
            raise ValueError(f"{what} on {t.device}, engine arrays on "
                             f"{self.arrays.a_vals.device}")
        return t.is_cuda

    def _check_flags(self, t: torch.Tensor, numel: int, what: str) -> None:
        """Validate an activity or liveness vector: contiguous uint8 on the
        engine's device."""
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"{what}: need a contiguous uint8 tensor")
        if t.numel() != numel:
            raise ValueError(f"{what}: {t.numel()} elements, expected {numel}")
        if t.device != self.arrays.a_vals.device:
            raise ValueError(f"{what} on {t.device}, engine arrays on "
                             f"{self.arrays.a_vals.device}")

    @property
    def _and_or(self) -> int:
        return int(self.semiring.op == OpType.ANDOR)

    @property
    def _op(self) -> int:
        """The semiring as K4 scatter takes it: 0 MULADD, 1 ANDOR, 2
        ADDMIN."""
        return int(self.semiring.op)

    @staticmethod
    def _raise_on(rc: int, name: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {rc}")

    # ---- K2 scatter ----------------------------------------------------------
    def scatter(self, x: torch.Tensor,
                arrays: RouterArrays | None = None) -> torch.Tensor:
        """Phases A+B only: the flush stream, (nsteps, f, 8, 128)."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_plain(x, a)
        stream = torch.zeros(self.nsteps * self.f * CHUNK,
                             dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.a_page, a.a_r, a.a_sub, a.a_vals,
                                       a.rg, a.target, x, stream)]
        rc = _build.library().glt_router_scatter(
            *ptrs, self.nsteps, self.cb, self.rstep, self.dstep, self._and_or,
            torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_router_scatter")
        self.launches["scatter"] += 1
        return stream.view(self.nsteps, self.f, 8, 128)

    # ---- K3 reduce -----------------------------------------------------------
    def reduce(self, stream: torch.Tensor,
               arrays: RouterArrays | None = None) -> torch.Tensor:
        """Phase C of the split pipeline: (nregions*region_rows,) rows."""
        a = self.arrays if arrays is None else arrays
        stream = stream.reshape(-1)
        if not self._check(stream, self.nsteps * self.f * CHUNK, "stream"):
            return self.reduce_plain(stream, a)
        y = torch.zeros(self.out_len, dtype=torch.float32,
                        device=stream.device)
        ptrs = [t.data_ptr() for t in (a.c_code, stream, a.c_hi, a.c_lo, y)]
        rc = _build.library().glt_router_reduce(
            *ptrs, self.nsteps * self.f, self.region_rows,
            torch.cuda.current_stream(stream.device).cuda_stream)
        self._raise_on(rc, "glt_router_reduce")
        self.launches["reduce"] += 1
        return y

    # ---- K1 fused ------------------------------------------------------------
    def fused_spmv(self, x: torch.Tensor,
                   arrays: RouterArrays | None = None) -> torch.Tensor:
        """Phases A+B+C in one kernel: (nregions*region_rows,) rows."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_plain(x, a)
        y = torch.zeros(self.out_len, dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.a_page, a.a_r, a.a_sub, a.a_vals,
                                       a.rg, a.target, a.c_code, a.c_hi,
                                       a.c_lo, x, y)]
        rc = _build.library().glt_router_fused(
            *ptrs, self.nsteps, self.cb, self.rstep, self.dstep,
            self.region_rows, self._and_or,
            torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_router_fused")
        self.launches["fused"] += 1
        return y

    # ---- SpMSpV: activity and live sets ----------------------------------------
    ACT_COLS = 128   # columns per activity flag: a page

    @property
    def num_act(self) -> int:
        return self.num_cols // self.ACT_COLS

    def activity(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 frontier activity, one flag per page: any x != 0 there."""
        return (x.reshape(self.num_act, self.ACT_COLS) != 0).any(1).to(
            torch.uint8)

    def chunk_units(self, a: RouterArrays | None = None) -> torch.Tensor:
        """(nsteps*cb,) int64: each A-chunk's activity flag, its page
        a_page*8 + the sublane byte of its first element (JAX
        `_chunk_activity`, page-granular)."""
        arr = self.arrays if a is None else a
        return arr.a_page.long() * 8 + arr.a_sub[::CHUNK].long()

    def _deposit_k(self, w1: torch.Tensor) -> torch.Tensor:
        """A-chunk within the step of a roll deposit word."""
        return w1 >> 20

    def deposit_units(self, a: RouterArrays | None = None):
        """(valid, unit), each (nsteps, dstep): whether the slot holds a
        deposit, and its chunk's activity flag."""
        own = a is None or a is self.arrays
        if own and self._deposits is not None:
            return self._deposits
        arr = self.arrays if a is None else a
        w1 = arr.rg[:, :self.dstep, 0].long()
        valid = arr.rg[:, :self.dstep, 1] > 0
        step = torch.arange(self.nsteps, device=w1.device)[:, None]
        chunk = torch.where(valid, step * self.cb + self._deposit_k(w1), 0)
        out = (valid, self.chunk_units(arr)[chunk])
        if own:
            self._deposits = out
        return out

    def live_deposits(self, act: torch.Tensor,
                      a: RouterArrays | None = None) -> torch.Tensor:
        """(nsteps, dstep) bool: deposits whose chunk is frontier-active
        (JAX `_predicate_rg`: the deposits whose w2 stays > 0)."""
        valid, unit = self.deposit_units(a)
        return valid & act.bool()[unit]

    def live_chunks(self, act: torch.Tensor,
                    a: RouterArrays | None = None) -> torch.Tensor:
        """(nsteps*f,) uint8: flush-stream chunks that some live deposit
        targets (JAX `_predicate_exact`'s cmask), scattered on the device
        with no host sync."""
        arr = self.arrays if a is None else a
        n = self.nsteps * self.f
        live = self.live_deposits(act, a)
        out = torch.zeros(n + 1, dtype=torch.uint8, device=act.device)
        out.index_fill_(0, torch.where(live, arr.target.long(), n).reshape(-1),
                        1)                 # slot n swallows the dead ones
        return out[:n]

    # ---- K2p, K3p, K1p ---------------------------------------------------------
    def scatter_predicated(self, x: torch.Tensor, act: torch.Tensor,
                           arrays: RouterArrays | None = None) -> torch.Tensor:
        """K2 over the live deposits only; dead deposits' elements stay
        zero. (nsteps, f, 8, 128)."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.scatter_plain(x, a, act)
        self._check_flags(act, self.num_act, "act")
        stream = torch.zeros(self.nsteps * self.f * CHUNK,
                             dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.a_page, a.a_r, a.a_sub, a.a_vals,
                                       a.rg, a.target, x, stream, act)]
        rc = _build.library().glt_router_scatter_pred(
            *ptrs, self.nsteps, self.cb, self.rstep, self.dstep, self._and_or,
            torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_router_scatter_pred")
        self.launches["scatter_pred"] += 1
        return stream.view(self.nsteps, self.f, 8, 128)

    def reduce_predicated(self, stream: torch.Tensor, live: torch.Tensor,
                          arrays: RouterArrays | None = None) -> torch.Tensor:
        """K3 over the live flush chunks only: (nregions*region_rows,)."""
        a = self.arrays if arrays is None else arrays
        stream = stream.reshape(-1)
        if not self._check(stream, self.nsteps * self.f * CHUNK, "stream"):
            return self.reduce_plain(stream, a, live)
        self._check_flags(live, self.nsteps * self.f, "live")
        y = torch.zeros(self.out_len, dtype=torch.float32,
                        device=stream.device)
        ptrs = [t.data_ptr() for t in (a.c_code, stream, a.c_hi, a.c_lo, y,
                                       live)]
        rc = _build.library().glt_router_reduce_pred(
            *ptrs, self.nsteps * self.f, self.region_rows,
            torch.cuda.current_stream(stream.device).cuda_stream)
        self._raise_on(rc, "glt_router_reduce_pred")
        self.launches["reduce_pred"] += 1
        return y

    def fused_predicated(self, x: torch.Tensor, act: torch.Tensor,
                         arrays: RouterArrays | None = None) -> torch.Tensor:
        """K1 over the live deposits only: (nregions*region_rows,)."""
        a = self.arrays if arrays is None else arrays
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_plain(x, a, act)
        self._check_flags(act, self.num_act, "act")
        y = torch.zeros(self.out_len, dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (a.a_page, a.a_r, a.a_sub, a.a_vals,
                                       a.rg, a.target, a.c_code, a.c_hi,
                                       a.c_lo, x, y, act)]
        rc = _build.library().glt_router_fused_pred(
            *ptrs, self.nsteps, self.cb, self.rstep, self.dstep,
            self.region_rows, self._and_or,
            torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, "glt_router_fused_pred")
        self.launches["fused_pred"] += 1
        return y

    # ---- plain PyTorch versions ----------------------------------------------
    def plain_index(self, a: RouterArrays | None = None) -> dict:
        """Per-element index vectors of the plain versions, expanded once
        from the descriptor words and targets: `src` (stream element of
        each deposited nnz), `col` (its x index), `dst` (its flush-stream
        position), `unit` (its chunk's activity flag) and `row` (output
        row of every flush-stream position; positions of unused chunks
        point one past the end)."""
        own = a is None or a is self.arrays
        if own and self._plain_index is not None:
            return self._plain_index
        arr = self.arrays if a is None else a
        w1 = arr.rg[:, :self.dstep, 0].reshape(-1).long()
        w2 = arr.rg[:, :self.dstep, 1].reshape(-1).long()
        active = w2 > 0
        step = torch.arange(self.nsteps, device=w1.device).repeat_interleave(
            self.dstep)[active]
        w1, w2 = w1[active], w2[active]
        tgt = arr.target.reshape(-1).long()[active]
        dst = w1 & 0x3FF
        delta = ((w1 >> 10) & 0x7F) + 128 * ((w1 >> 17) & 0x7)
        src = (dst - delta) & (CHUNK - 1)
        chunk = step * self.cb + (w1 >> 20)
        ln = w2 >> 16
        nel = int(ln.sum())
        first = torch.cumsum(ln, 0) - ln
        rep = torch.repeat_interleave(torch.arange(len(ln), device=ln.device),
                                      ln, output_size=nel)
        off = torch.arange(nel, device=ln.device) - first[rep]
        el_src = chunk[rep] * CHUNK + src[rep] + off
        el_col = (arr.a_page.long()[chunk[rep]] * CHUNK
                  + arr.a_sub[el_src].long() * 128 + arr.a_r[el_src].long())
        el_dst = tgt[rep] * CHUNK + dst[rep] + off
        idx = dict(src=el_src, col=el_col, dst=el_dst,
                   unit=self.chunk_units(arr)[chunk[rep]], row=self._rows(arr))
        if own:
            self._plain_index = idx
        return idx

    def _rows(self, arr) -> torch.Tensor:
        """Output row of every flush-stream position; positions of unused
        chunks point one past the end."""
        code = arr.c_code.long().repeat_interleave(CHUNK)
        return torch.where(
            code >= 0,
            code * self.region_rows + arr.c_hi.long() * 128 + arr.c_lo.long(),
            torch.full_like(code, self.out_len))

    def scatter_plain(self, x: torch.Tensor, a: RouterArrays | None = None,
                      act: torch.Tensor | None = None) -> torch.Tensor:
        """K2's plain version: gather, then index_copy_ into a zeroed flush
        stream through the deposit targets. With `act`, K2p's: only the
        elements of frontier-active chunks. ADDMIN (the tropical pass 1)
        stores int32 encodings (semiring.tropical_encode)."""
        arr = self.arrays if a is None else a
        idx = self.plain_index(a)
        if act is not None:
            keep = act.bool()[idx["unit"]]
            idx = {k: idx[k][keep] for k in ("src", "col", "dst")}
        vals = arr.a_vals[idx["src"]]
        xg = x.reshape(-1)[idx["col"]]
        if self.semiring.op == OpType.ADDMIN:
            g = tropical_encode(vals, xg)
        elif self._and_or:
            g = torch.logical_and(vals != 0, xg != 0).to(torch.float32)
        else:
            g = vals * xg
        stream = torch.zeros(self.nsteps * self.f * CHUNK, dtype=g.dtype,
                             device=x.device)
        stream.index_copy_(0, idx["dst"], g)
        return stream.view(self.nsteps, self.f, 8, 128)

    def reduce_plain(self, stream: torch.Tensor, a: RouterArrays | None = None,
                     live: torch.Tensor | None = None) -> torch.Tensor:
        """K3's plain version: index_add_ of the flush stream into y. With
        `live`, K3p's: only the live flush chunks."""
        row = self.plain_index(a)["row"]
        if live is not None:
            row = torch.where(live.bool().repeat_interleave(CHUNK), row,
                              self.out_len)
        y = torch.zeros(self.out_len + 1, dtype=torch.float32,
                        device=stream.device)
        y.index_add_(0, row, stream.reshape(-1))
        return y[:self.out_len]

    def fused_plain(self, x: torch.Tensor, a: RouterArrays | None = None,
                    act: torch.Tensor | None = None) -> torch.Tensor:
        """K1's plain version: K2's then K3's; with `act`, K1p's."""
        return self.reduce_plain(self.scatter_plain(x, a, act), a)

    # ---- SpMV and SpMSpV -------------------------------------------------------
    def __call__(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                 mask_type: MaskType | None = None,
                 arrays: RouterArrays | None = None) -> torch.Tensor:
        """One SpMV, y = mask(A (x) x), (num_rows,)."""
        if self.fused:
            y = self.fused_spmv(x, arrays)
        else:
            y = self.reduce(self.scatter(x, arrays), arrays)
        return self._epilogue(y, mask, mask_type)

    def call_predicated(self, x: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        mask_type: MaskType | None = None,
                        arrays: RouterArrays | None = None) -> torch.Tensor:
        """One SpMSpV on a dense frontier (x = 0 off the frontier):
        `__call__`'s result, through K1p or K2p -> K3p by the same fused
        rule."""
        act = self.activity(x)
        if self.fused:
            y = self.fused_predicated(x, act, arrays)
        else:
            y = self.reduce_predicated(self.scatter_predicated(x, act, arrays),
                                       self.live_chunks(act, arrays), arrays)
        return self._epilogue(y, mask, mask_type)

    def _epilogue(self, y, mask, mask_type):
        """The ANDOR 0/1 clamp and the SpMV mask on the first num_rows."""
        mt = self.mask_type if mask_type is None else mask_type
        y = y[:self.num_rows]
        if self.semiring.op == OpType.ANDOR:
            y = (y != 0).to(y.dtype)
        if mask is not None and mt != MaskType.NO_MASK:
            y = apply_mask(y, mask, mt, self.semiring.zero)
        return y
