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

K1 and K1p do not read the layout's streams. At init the engine derives
two padding-free device forms (`router_entries`): every real element of
every live deposit as an f32 value and one int32 word (its column within
its segment's column window | its row within the region << col_bits,
the row read once from c_hi/c_lo at the element's flush position),
beside one record per segment (first element, x offset, y offset,
activity flag) and a table of blocks of `ENTRIES_PER_BLOCK` consecutive
elements. K1 reads `entries`, sorted by row within each region (one
segment per region and window of 2**col_bits columns: the whole of x on
the googleplus stand-in), so a row's products meet in registers and
across the warp and reach y with few atomics. K1p reads `pred_entries`,
in deposit order (one segment per deposit, x offset its page), so a dead
page's deposits are skipped unread. `init_seconds` times both. Their CPU
path (`fused_entries_plain`) walks the forms; `fused_plain` (K2's plain
version, then K3's) stays the reference they are held to.

K3 runs one block per group of the region-group table `groups`, derived
at init too (`reduce_groups`: the flushed chunks sorted by region, cut
into groups of at most REDUCE_GROUP_CHUNKS chunks of one region): each
block sums its chunks in a shared tile of the region's rows and reaches y
once per quad of rows. Its CPU path is `reduce_plain` (index_add_
through `plain_index`). K3 and K1 read only what the engine derived from
its own arrays: another engine's `arrays` raise.

SpMSpV (`call_predicated`, JAX `__call__(tiles_active=, fidx=)`) runs the
frontier-predicated forms K1p, K2p -> K3p (`*_predicated`, counted as
`fused_pred`, `scatter_pred`, `reduce_pred`). Activity is per 128-column
page (`activity`; a roll A-chunk holds one page). A deposit whose chunk's
page is inactive gathers only zeros and is skipped; K3p skips the flush
chunks that no live deposit targets (`live_chunks`, scattered on the
device from the deposit targets), a block per chunk. That is the
keep-set of JAX
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
import time

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

# K1's grid: consecutive elements of its derived form per block (PERF.md,
# PR 8), and the elements a kernel thread loads at once.
ENTRIES_PER_BLOCK = 4096
VECTOR = 8
PAGE_COL_BITS = 10   # column within a 1024-column page
# Segments a block holds at most: a block is also cut at every
# BLOCK_SEGMENTS-th segment start, so the kernels' shared table of
# segment records (12 B each) stays at 12 KB on forms of tiny segments
# (a hub-free region's (region, tile) windows) and does not cap occupancy.
BLOCK_SEGMENTS = 1024
# Phase C's grid (K3, K11): flushed chunks of one region a block sums in
# its shared tile of the region's rows before anything reaches y
# (`reduce_groups`). A block walks its chunks in sequence, so smaller
# groups (more blocks in flight) ran faster, down to 8, against the tile's
# zero and flush per group. 8 is a stand-in: it was timed only on forced
# split runs of the pokec and googleplus stand-ins (ab_kernels.py
# --kernels reduce, PERF.md §6; googleplus ran 5% faster at 4), which the
# engine serves fused. It waits for a graph whose y outgrows
# FUSED_MAX_Y_BYTES, the split branch's own traffic.
REDUCE_GROUP_CHUNKS = 8


@dataclasses.dataclass
class RouterEntries:
    """A padding-free device form of a roll or planar layout,
    `router_entries`: for K1 and K4 fused ("row" order), K1p ("deposit"),
    K4p fused ("row" in windows of one column tile) or K4 scatter
    ("stream"). A segment is a deposit or piece (the elements one
    descriptor slot moves) or, in row order, a (region, column window)."""

    # (N,) each, views of storage zeroed to a multiple of VECTOR elements
    # (the kernel's vector loads; no block names an element past N)
    vals: torch.Tensor | None  # float32; None in the ANDOR form without
                               # values (every stored value nonzero)
    idx: torch.Tensor      # int32: col | row << col_bits ("stream": the
                           # slot within the target flush chunk for row)
    deps: torch.Tensor     # (ndep, 4) int32: first element, x offset,
                           # y (or stream) offset, activity flag (-1: none)
    blocks: torch.Tensor   # (nblk, 4) int32: elements [e0, e1) of
                           # segments [g0, g1)
    max_segments: int      # largest g1 - g0 (the kernel's shared table)
    col_bits: int
    order: str             # "deposit", "row" or "stream"
    # "stream" only: (nchunks*8,) uint8, the lanes its elements fill in
    # each (flush chunk, sublane), which they fill from lane 0 up (None
    # where they do not): K4 scatter zeroes the rest instead of the
    # whole stream
    tails: torch.Tensor | None = None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.vals, self.idx, self.deps, self.blocks, self.tails)
            if t is not None)


def _vector_storage(t: torch.Tensor) -> torch.Tensor:
    """`t` copied into storage zeroed to a multiple of VECTOR elements."""
    n = t.numel()
    out = torch.zeros(-(-n // VECTOR) * VECTOR, dtype=t.dtype,
                      device=t.device)[:n]
    return out.copy_(t)


def router_entries(eng: "RouterSpMV", order: str = "row",
                   block_entries: int = ENTRIES_PER_BLOCK,
                   col_bits: int | None = None,
                   values: bool | None = True,
                   col_bits_no_values: int | None = None,
                   block_segments: int = BLOCK_SEGMENTS,
                   index: dict | None = None) -> RouterEntries:
    """A device form of `eng`'s layout for K1 or K1p (or, on a planar
    engine, K4 fused, K4p fused or K4 scatter), built with torch ops on
    the engine's device from its element index: every element of a live
    deposit (one whose flush chunk has a region; in "stream" order every
    deposited element), once, with its x column (`eng.x_columns`).

    "row" (K1's, K4 fused's, K4p fused's): the elements of each (region,
    window of 2**col_bits columns) sorted by (row, column), one segment
    each, x offset the window's first column; col_bits defaults to what
    the word has left after the row within the region (31 - its bits: 18
    on the googleplus stand-in, one window; 18 on the pokec stand-in, 7).
    It holds the matrix's (row, column, value) triples and nothing of the
    layout's deal. A window no wider than `eng.ACT_COLS` lies in one
    activity unit, which is its flag (the planar tile form, col_bits 10);
    wider windows have none (-1). "deposit" (K1p's): deposit order, one
    segment per deposit, x offset its page, activity flag its page's.
    "stream" (K4 scatter's store form): the same, with each element's slot
    within its target flush chunk in place of its row and the chunk's
    first stream position as the segment's offset, and the `tails` of the
    stream's (chunk, sublane) rows where the elements fill a prefix of
    each (the packers' per-sublane cursors start at lane 0, so they do on
    every layout seen). `values=False` (ANDOR only) drops the value
    stream; it raises unless every stored value is nonzero. `values=None` drops it where it may (an ANDOR engine whose
    stored values are all nonzero) and keeps it otherwise; a form without
    it takes `col_bits_no_values` where given. Blocks hold at most
    `block_entries` elements and `block_segments` segments. `index` is
    `resolved_index(eng)`, computed when None (pass it to derive several
    forms from one decode)."""
    a = eng.arrays
    idx = resolved_index(eng) if index is None else index
    dev = a.a_vals.device
    src, col, dst, unit, dep = (idx[k] for k in
                                ("src", "col", "dst", "unit", "dep"))
    if order == "stream":
        if values is not True:
            raise ValueError("the store form keeps its values")
        if eng.nsteps * eng.f * CHUNK >= 2**31:
            raise ValueError("the flush stream outgrows the form's int32 "
                             "offsets")
    else:
        code = a.c_code.long()[dst // CHUNK]
        keep = code >= 0
        src, col, dst, unit, dep, code = (t[keep] for t in
                                          (src, col, dst, unit, dep, code))
    vals = a.a_vals[src]
    and_or = eng.semiring.op == OpType.ANDOR
    if values is None:
        values = not (and_or and bool((vals != 0).all()))
    elif not values:
        if not and_or:
            raise ValueError("only the ANDOR form drops its values")
        if not bool((vals != 0).all()):
            raise ValueError("a stored value is zero: the ANDOR form "
                             "without values would count its element")
    if not values and col_bits_no_values is not None:
        col_bits = col_bits_no_values
    if order == "stream":
        row, yo = dst % CHUNK, dst - dst % CHUNK
    else:
        row = a.c_hi[dst].long() * 128 + a.c_lo[dst].long()
        yo = code * eng.region_rows
    if order in ("deposit", "stream"):
        col_bits = PAGE_COL_BITS
        key = dep
        xo, flag = col // CHUNK * CHUNK, unit
    elif order == "row":
        if col_bits is None:
            col_bits = 31 - int(eng.region_rows - 1).bit_length()
        window = col >> col_bits
        key = code * (int(eng.num_cols >> col_bits) + 1) + window
        # repeated (row, column) pairs in value order, so the form does
        # not depend on the order the layout deals them in
        perm = torch.argsort(vals.view(torch.int32), stable=True)
        perm = perm[torch.argsort(((key * eng.region_rows + row)
                                   * eng.num_cols + col)[perm], stable=True)]
        col, row, yo, key, vals = (t[perm] for t in
                                   (col, row, yo, key, vals))
        xo = col >> col_bits << col_bits
        flag = (col // eng.ACT_COLS if 1 << col_bits <= eng.ACT_COLS
                else torch.full_like(col, -1))
    else:
        raise ValueError(f"unknown order {order!r}")
    if (order != "stream"
            and int(eng.region_rows - 1).bit_length() > 31 - col_bits):
        raise ValueError(f"a row within the region needs more than the "
                         f"{31 - col_bits} bits left beside the column")
    n = src.numel()
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head).flatten()
    i32 = lambda t: t.to(torch.int32).contiguous()
    deps = i32(torch.stack([starts, xo[starts], yo[starts], flag[starts]],
                           1))
    # blocks of `block_entries` elements, also cut at every
    # `block_segments`-th segment start; a form with no elements has none
    e0 = torch.unique(torch.cat([
        torch.arange(0, n, block_entries, device=dev),
        starts[::block_segments]]))
    e1 = torch.cat([e0[1:], e0.new_tensor([n])])[:len(e0)]
    g0 = torch.searchsorted(starts, e0, right=True) - 1
    g1 = torch.searchsorted(starts, e1 - 1, right=True)
    return RouterEntries(
        vals=_vector_storage(vals) if values else None,
        idx=_vector_storage(i32((col - xo) | row << col_bits)),
        deps=deps, blocks=i32(torch.stack([e0, e1, g0, g1], 1)),
        max_segments=int((g1 - g0).max()) if n else 0, col_bits=col_bits,
        order=order,
        tails=stream_tails(dst, eng.nsteps * eng.f) if order == "stream"
        else None)


def resolved_index(eng: "RouterSpMV") -> dict:
    """`eng.element_index` of its own arrays with each element's `col`
    resolved to its x column (`eng.x_columns`): what `router_entries`
    derives a form from."""
    idx = eng.element_index(eng.arrays)
    return dict(idx, col=eng.x_columns(idx["col"]))


def stream_tails(dst: torch.Tensor, nchunks: int) -> torch.Tensor | None:
    """(nchunks*8,) uint8: how many lanes of each (flush chunk, sublane)
    the elements at stream positions `dst` fill, or None unless they fill
    lanes [0, count) of every one."""
    rows = dst // 128
    count = torch.bincount(rows, minlength=nchunks * 8)
    last = torch.full_like(count, -1).scatter_reduce_(0, rows, dst % 128,
                                                      "amax")
    if not bool((last + 1 == count).all()):
        return None
    return count.to(torch.uint8)


@dataclasses.dataclass
class ReduceGroups:
    """Phase C's grid (`reduce_groups`): the flushed chunks by region, cut
    into groups of at most REDUCE_GROUP_CHUNKS chunks of one region."""

    order: torch.Tensor    # (nlive,) int32: flushed chunks, by region
    groups: torch.Tensor   # (ngroups, 4) int32: first position in order,
                           # chunks, region, 1 where it is the region's
                           # only group

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.order, self.groups))


def reduce_groups(c_code: torch.Tensor,
                  group_chunks: int | None = None) -> ReduceGroups:
    """The region-group table of a flush stream whose chunk codes are
    `c_code` (region, or -1 where the chunk is never flushed), built with
    torch ops on its device: the flushed chunks sorted stably by region,
    and each region's run of them cut into groups of at most
    `group_chunks` (REDUCE_GROUP_CHUNKS when None). K3 and K11 run one
    block per group; a region's only group writes its rows of y with plain
    stores. A stream with no flushed chunk gives an empty table."""
    if group_chunks is None:
        group_chunks = REDUCE_GROUP_CHUNKS
    if group_chunks < 1:
        raise ValueError("a group holds at least one chunk")
    code = c_code.long()
    live = torch.nonzero(code >= 0).flatten()
    order = live[torch.argsort(code[live], stable=True)]
    region = code[order]
    n = order.numel()
    pos = torch.arange(n, device=code.device)
    head = torch.ones(n, dtype=torch.bool, device=code.device)
    head[1:] = region[1:] != region[:-1]
    starts = torch.nonzero(head).flatten()          # each region's first
    rid = torch.cumsum(head.long(), 0) - 1          # region run of each
    first = ((pos - starts[rid]) % group_chunks == 0).nonzero().flatten()
    count = torch.diff(first, append=first.new_tensor([n]))
    size = torch.diff(starts, append=starts.new_tensor([n]))
    sole = size[rid[first]] <= group_chunks
    i32 = lambda t: t.to(torch.int32).contiguous()
    return ReduceGroups(order=i32(order), groups=i32(torch.stack(
        [first, count, region[first], sole.long()], 1)).reshape(-1, 4))


def entries_index(e: RouterEntries):
    """(col, row, flag) of every element of the form `e`, int64, expanded
    from its segment records and its elements' words."""
    n = e.idx.numel()
    deps = e.deps.long()
    first = torch.cat([deps[:, 0], deps.new_tensor([n])])
    seg = torch.repeat_interleave(
        torch.arange(len(deps), device=deps.device), first[1:] - first[:-1],
        output_size=n)
    w = e.idx.long() & 0xFFFFFFFF
    return (deps[seg, 1] + (w & ((1 << e.col_bits) - 1)),
            deps[seg, 2] + (w >> e.col_bits), deps[seg, 3])


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
        t0 = time.perf_counter()
        self.entries = router_entries(self, "row")              # K1's
        self.pred_entries = router_entries(self, "deposit")     # K1p's
        self.groups = reduce_groups(self.arrays.c_code)         # K3's
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0   # the derived forms
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
        self._entries_index = {}   # id(form) -> (form, its index)
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
        """The semiring as K1's kernel and K4 scatter take it: 0 MULADD,
        1 ANDOR, 2 ADDMIN."""
        return int(self.semiring.op)

    @property
    def _stream_dtype(self) -> torch.dtype:
        """float32, or int32 for the tropical engine's ADDMIN encodings."""
        return torch.int32 if self.TROPICAL else torch.float32

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
    _reduce_key = "reduce"   # its launch counter (K11's on PERM-C layouts)

    def reduce(self, stream: torch.Tensor,
               arrays: RouterArrays | None = None) -> torch.Tensor:
        """Phase C of the split pipeline: (nregions*region_rows,) rows,
        one block per group of the region-group table `groups`, over the
        rows c_hi/c_lo, both derived from the engine's own arrays (on a
        PERM-C planar engine this is K11: the rows are position-keyed)."""
        self._own_arrays(arrays)
        stream = stream.reshape(-1)
        if not self._check(stream, self.nsteps * self.f * CHUNK, "stream"):
            return self.reduce_plain(stream)
        g, a = self.groups, self.arrays
        if stream.data_ptr() % 16:
            raise ValueError("stream: the kernel reads it with 16-byte loads "
                             "and needs it 16-byte aligned")
        y = torch.zeros(self.out_len, dtype=torch.float32,
                        device=stream.device)
        ptrs = [t.data_ptr() for t in (g.groups, g.order, stream, a.c_hi,
                                       a.c_lo, y)]
        with torch.cuda.device(stream.device):   # the tile's opt-in is per card
            rc = _build.library().glt_router_reduce(
                *ptrs, g.groups.shape[0], self.region_rows,
                torch.cuda.current_stream(stream.device).cuda_stream)
        self._raise_on(rc, "glt_router_reduce")
        self.launches[self._reduce_key] += 1
        return y

    # ---- K1 fused ------------------------------------------------------------
    def use_entries(self, entries: RouterEntries,
                    pred: bool = False) -> None:
        """K1 (K1p with `pred`) reads `entries` from now on: another order
        or block size of `router_entries`. K1p skips dead segments by their
        flags, so its form needs one on every segment: deposit order, or
        row order in windows no wider than an activity unit."""
        if pred and (entries.order == "stream"
                     or bool((entries.deps[:, 3] < 0).any())):
            raise ValueError("K1p skips dead pages by segment: it needs the "
                             "deposit-order form or windows of one "
                             "activity unit")
        old = self.pred_entries if pred else self.entries
        self._entries_index.pop(id(old), None)
        if pred:
            self.pred_entries = entries
        else:
            self.entries = entries

    def _own_arrays(self, arrays: RouterArrays | None) -> None:
        if arrays is not None and arrays is not self.arrays:
            raise ValueError("the kernels read the forms derived from the "
                             "engine's own arrays")

    def fused_spmv(self, x: torch.Tensor,
                   arrays: RouterArrays | None = None) -> torch.Tensor:
        """Phases A+B+C in one kernel: (nregions*region_rows,) rows."""
        self._own_arrays(arrays)
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_entries_plain(x)
        return self._launch_fused(x, None, "glt_router_fused", "fused")

    def _launch_fused(self, x: torch.Tensor, act: torch.Tensor | None,
                      name: str, key: str) -> torch.Tensor:
        """Zero y (the tropical pass 1's int32 out of encodings) and launch
        K1 over `entries` (K1p over `pred_entries` when `act` is given) on
        the current stream. A form without values passes a null value
        pointer."""
        e = self.entries if act is None else self.pred_entries
        y = torch.zeros(self.out_len, dtype=self._stream_dtype,
                        device=x.device)
        ptrs = [None if t is None else t.data_ptr()
                for t in (e.blocks, e.deps, e.vals, e.idx, x, y)]
        if act is not None:
            ptrs.append(act.data_ptr())
        rc = getattr(_build.library(), name)(
            *ptrs, e.blocks.shape[0], e.max_segments, e.col_bits,
            self._op, torch.cuda.current_stream(x.device).cuda_stream)
        self._raise_on(rc, name)
        self.launches[key] += 1
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
        self._own_arrays(arrays)
        x = x.reshape(-1)
        if not self._check(x, self.num_cols, "x"):
            return self.fused_entries_plain(x, act, self.pred_plain_entries())
        self._check_flags(act, self.num_act, "act")
        return self._launch_fused(x, act, "glt_router_fused_pred",
                                  "fused_pred")

    def pred_plain_entries(self) -> RouterEntries:
        """The form K1p's plain version walks: K1's row form, filtered by
        page, so that on a frontier x it equals K1's walk bit for bit."""
        return self.entries

    # ---- plain PyTorch versions ----------------------------------------------
    def plain_index(self, a: RouterArrays | None = None) -> dict:
        """Per-element index vectors of the plain versions, expanded once
        from the descriptor words and targets: `src` (stream element of
        each deposited nnz), `col` (its x index), `dst` (its flush-stream
        position), `unit` (its chunk's activity flag), `dep` (its live
        deposit) and `row` (output row of every flush-stream position;
        positions of unused chunks point one past the end)."""
        own = a is None or a is self.arrays
        if own and self._plain_index is not None:
            return self._plain_index
        arr = self.arrays if a is None else a
        idx = dict(self.element_index(arr), row=self._rows(arr))
        if own:
            self._plain_index = idx
        return idx

    def element_index(self, arr: RouterArrays) -> dict:
        """`plain_index` without `row` and uncached, plus `dep` (the live
        deposit of each element, in slot order)."""
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
        return dict(src=el_src, col=el_col, dst=el_dst,
                    unit=self.chunk_units(arr)[chunk[rep]], dep=rep)

    def x_columns(self, col: torch.Tensor) -> torch.Tensor:
        """x index of each element whose gather index is `col`: the same
        on the roll router."""
        return col

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
        g = self._product(arr.a_vals[idx["src"]], x.reshape(-1)[idx["col"]])
        stream = torch.zeros(self.nsteps * self.f * CHUNK, dtype=g.dtype,
                             device=x.device)
        stream.index_copy_(0, idx["dst"], g)
        return stream.view(self.nsteps, self.f, 8, 128)

    def _product(self, vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
        """The semiring's (x) in the plain versions: v * x (one rounding),
        ANDOR's 0/1, or ADDMIN's int32 encoding (semiring.tropical_encode)."""
        if self.semiring.op == OpType.ADDMIN:
            return tropical_encode(vals, xg)
        if self._and_or:
            return torch.logical_and(vals != 0, xg != 0).to(torch.float32)
        return vals * xg

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
        """K2's plain version then K3's, through the flush stream; with
        `act`, K2p's then K3's. K1's reference."""
        return self.reduce_plain(self.scatter_plain(x, a, act), a)

    def entries_index(self, entries: RouterEntries | None = None):
        """`entries_index` of `entries` (the engine's `entries` when None),
        expanded once per form."""
        e = self.entries if entries is None else entries
        hit = self._entries_index.get(id(e))
        if hit is None or hit[0] is not e:
            hit = self._entries_index[id(e)] = (e, entries_index(e))
        return hit[1]

    def fused_entries_plain(self, x: torch.Tensor,
                            act: torch.Tensor | None = None,
                            entries: RouterEntries | None = None
                            ) -> torch.Tensor:
        """K1's plain version: gather and product over `entries` (the
        engine's `entries` when None), then index_add_ into y; with `act`,
        K1p's: the same over the elements of active pages (tiles on a
        planar engine) only. Each row's products are added in the form's
        order: by column, then value bits, in every row-ordered form, so
        where x is zero off the active units the two agree bit for bit (a
        skipped element adds zero). ADDMIN (the tropical walk): each
        element's int32 encoding scatter_reduce_'d with amax into a zeroed
        out, exact in any order."""
        e = self.entries if entries is None else entries
        col, row, _ = self.entries_index(e)
        vals = e.vals
        if vals is None:          # the ANDOR form without values
            vals = torch.ones(col.numel(), device=col.device)
        if act is not None:
            keep = act.bool()[col // self.ACT_COLS]
            col, row, vals = col[keep], row[keep], vals[keep]
        g = self._product(vals, x.reshape(-1)[col])
        y = torch.zeros(self.out_len, dtype=g.dtype, device=x.device)
        if self.semiring.op == OpType.ADDMIN:
            return y.scatter_reduce_(0, row, g, "amax")
        return y.index_add_(0, row, g)

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
