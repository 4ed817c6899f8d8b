"""Tropical (min-plus) SpMV layout: the split-pass schedule builder (numpy,
host side).

The port's copy of the numpy path of `graphlily_tpu/io/tropical_format.py`
(its `native=False` path: the C++ schedule builder is ROADMAP item 5a):
for every input it builds the same arrays bit for bit, and the tests hold
the two equal. The engine that runs it is ops/tropical.py.

Why a layout of its own: min has no matrix-unit form, and the flush-stream
reduce of the planar router (K3, K4 fused) adds. The tropical engine keeps
the planar pass 1 and replaces the reduce with two passes built here:

  1. PASS 1, planar (io/planar_format.pack_planar with hi_pad=-1 and
     pad_val=FLOAT_INF): values ride raw, clipped to [0, FLOAT_INF]; the
     K4 scatter writes each product's exact int32 encoding
     E = INF_BITS - bits(min(val + x, FLOAT_INF)) (semiring.tropical_encode),
     which reverses the order of non-negative floats, so the min becomes
     an int32 max whose identity 0 (= E(FLOAT_INF)) is what the zeroed
     stream and every padding slot hold. The flush stream groups values
     by `region_rows`-row region.
  2. SPLIT: one more static deposit pass (descriptors in the planar
     format) splits each region's stream into 128-row WINDOW-pure chunks:
     a radix step whose digit is the row's window within its region.
     Input is consumed region-major (`in_order`), so only region_rows/128
     digit accumulators are live; their cycles rotate through K slots.
  3. WINDOW REDUCE: per window-pure chunk a per-sublane sort (`sort2`)
     makes every (sublane, row) one contiguous lane run (`rowids` gives
     the row of each sorted slot, `inv2` each run's end lane), and the max
     of every run lands in the window's row of the (nwin, 128) output. The
     epilogue decodes y = bits^-1(INF_BITS - out).

`compact_window_stream` lets consecutive split steps share one block of
f2 window chunks (`qblk2`), so the window stream is sized by the flushes
it holds, not by nsteps2 times the busiest step.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..config import DEFAULT_CONFIG
from ..semiring import FLOAT_INF
from .matrix import CSRMatrix
from .planar_format import (PlanarSpMVLayout, pack_planar, simulate_cursors,
                            planes_to_triples)
from .router_format import CHUNK, MAX_REGIONS

S = 8
L = 128
W = 128   # window rows (the reduce's granularity, = lanes)
SPLIT_FORMATS = ("planes", "triples")


@dataclasses.dataclass
class TropicalSpMVLayout:
    """Planar pass-1 layout + split and reduce pass schedules (all numpy)."""

    planar: PlanarSpMVLayout
    # ---- split pass (region stream -> window-pure stream) ----
    in_order: np.ndarray    # (nsteps2*kb,) int32: pass-1 stream chunk ids in
                            #   region-major order (pads repeat a chunk that
                            #   no descriptor reads)
    rg2: np.ndarray         # (nsteps2, rstep2, 2) int32, phase-ordered:
                            #   deposits [0, dstep2): w1 = k | p<<8,
                            #     w2 = slot12 | 1<<15
                            #   flushes [dstep2, rstep2): w1 = 0,
                            #     w2 = slot12 | q<<16 | 1<<31 (q: chunk in
                            #     the step's block, see qblk2)
    planes2: np.ndarray     # (nsteps2, dmax2, 8, 128) int8 deposit planes;
                            #   (0, 0, 8, 128) in the "triples" format
    # ---- window reduce pass ----
    c_win: np.ndarray       # (nblocks2*f2,) int32 global window (-1 skip)
    sort2: np.ndarray       # (nblocks2*f2, 8, 128) int8 per-sublane sort
                            #   (source lane of each sorted slot)
    rowids: np.ndarray      # (nblocks2*f2, 8, 128) int8 row-in-window of
                            #   each sorted slot (padding rides as 127)
    inv2: np.ndarray        # (nblocks2*f2, 8, 128) int8 run-end lane per
                            #   (sublane, window row); v < 0 valid (v&127)
    num_rows: int
    num_cols: int
    nnz: int
    num_windows: int        # padded_rows / 128
    region_digits: int      # region_rows / 128
    kb: int                 # split-pass input chunks per step
    rstep2: int
    f2: int
    dmax2: int
    nsteps2: int
    fill2: float            # nnz / window-stream slots
    dstep2: int = 0         # deposit slots per split step (rstep2 - f2)
    num_slots2: int = 0     # rotated digit slots
    # ---- "triples" split format ----
    xsort2: np.ndarray | None = None    # (nsteps2, kb, 8, 128) int32
                                        #   digit-major sort per chunk
    triples2: np.ndarray | None = None  # (nsteps2, ceil(dmax2/128), 8, 128)
                                        #   int32: a0 | d0<<7 | n<<14
    # ---- compact window stream ----
    qblk2: np.ndarray | None = None     # (nsteps2,) int32 block of each
                                        #   step's flushes (monotone)
    nblocks2: int = 0                   # window stream height in blocks

    @property
    def mem_bytes(self) -> int:
        extra = sum(a.nbytes for a in (self.xsort2, self.triples2,
                                       self.qblk2)
                    if a is not None)
        return (self.planar.mem_bytes + self.in_order.nbytes
                + self.rg2.nbytes + self.planes2.nbytes + self.c_win.nbytes
                + self.sort2.nbytes + self.rowids.nbytes + self.inv2.nbytes
                + extra)

    @property
    def num_col_tiles(self) -> int:
        return self.planar.num_col_tiles


def choose_tropical_region_rows(nrows: int) -> int:
    """Pass-1 regions must fit MAX_REGIONS; larger regions cut pass-1
    deposits but raise the split pass's digits per chunk. The 2048 floor
    keeps pass-1 deposit counts near the MULADD path's on small graphs."""
    need = -(-nrows // MAX_REGIONS)
    return max(2048, -(-need // 128) * 128)


def _schedule_flushes(er, dl, tie, nsteps):
    """Spread every split-pass flush (cycle splits and residual drains)
    over the steps where it may legally run, so that f2, the flush width
    that sizes the window stream and the reduce tables, stays near the
    average load.

    A flush of (digit, global cycle g) may run at any step in [er, dl]:
    er is the step of the deposit that closed the cycle, dl one step before
    the first deposit of (digit, g + K0), which reuses the K-rotated slot.
    Greedy: walk the steps, keep the available flushes in a (deadline,
    tie) min-heap, fill each step to a cap; a flush whose deadline is the
    current step goes regardless. The cap is the smallest whose greedy run
    never exceeds it (binary search). Deterministic: `tie` is the flush's
    unique region-cycle id.

    Returns (order, steps): flush indices in placement order and their
    steps (non-decreasing)."""
    n = len(er)
    by_er = [[] for _ in range(nsteps)]
    for i in range(n):
        by_er[int(er[i])].append(i)

    def run(cap, emit):
        heap: list = []
        order = np.empty(n, np.int64) if emit else None
        steps_out = np.empty(n, np.int64) if emit else None
        pos = 0
        maxload = 0
        for s in range(nsteps):
            for i in by_er[s]:
                heapq.heappush(heap, (int(dl[i]), int(tie[i]), i))
            load = 0
            while heap and (heap[0][0] == s or load < cap):
                _, _, i = heapq.heappop(heap)
                if emit:
                    order[pos] = i
                    steps_out[pos] = s
                pos += 1
                load += 1
            maxload = max(maxload, load)
        assert pos == n, "flush scheduler left pending flushes"
        return maxload, order, steps_out

    lo = max(-(-n // max(nsteps, 1)), 1)
    hi = lo
    while run(hi, False)[0] > hi:
        hi *= 2
    while lo < hi:
        mid = (lo + hi) // 2
        if run(mid, False)[0] <= mid:
            hi = mid
        else:
            lo = mid + 1
    _, order, steps_out = run(lo, True)
    return order, steps_out


def build_split_schedule(lay: PlanarSpMVLayout, kb: int = 16) -> dict:
    """Split and reduce schedules from a planar layout packed with
    hi_pad=-1. Reads only its structure (c_code, c_hi, c_lo); returns the
    layout fields other than the planar layout itself."""
    R = lay.region_rows // W
    assert R <= 512, "digit accumulators exceed the slot budget"
    nwin = lay.num_rows // W
    c_code = np.asarray(lay.c_code)
    valid = np.nonzero(c_code >= 0)[0]
    # region-major, cycle creation order kept inside a region
    in_order = valid[np.argsort(c_code[valid], kind="stable")]
    n_in = len(in_order)
    nsteps2 = max(-(-n_in // kb), 1)
    regions = c_code[in_order].astype(np.int64)

    hi = np.asarray(lay.c_hi)[in_order].astype(np.int64)   # (n_in, 8, 128)
    lo = np.asarray(lay.c_lo)[in_order].astype(np.int64)

    # ---- elements, sorted (chunk, digit, sublane, row, lane) --------------
    ci, si, li = np.nonzero(hi >= 0)
    dg = hi[ci, si, li]
    rw = lo[ci, si, li]
    del hi, lo
    order = np.lexsort((li, rw, si, dg, ci))
    ci, si, li, dg, rw = (a[order] for a in (ci, si, li, dg, rw))
    nel = len(ci)
    assert nel, "empty layout"

    # ---- deposits: (chunk, digit) groups, per-sublane lengths -------------
    nd_mask = np.ones(nel, bool)
    nd_mask[1:] = (ci[1:] != ci[:-1]) | (dg[1:] != dg[:-1])
    dep_first = np.nonzero(nd_mask)[0]
    dep_count = np.diff(np.concatenate([dep_first, [nel]]))
    nd = len(dep_first)
    dep_chunk = ci[dep_first]
    dep_digit = dg[dep_first]
    dep_of_el = np.repeat(np.arange(nd), dep_count)
    d_lens = np.zeros((nd, S), np.int64)
    ds_key = dep_of_el * S + si
    ds_ids, ds_cnt = np.unique(ds_key, return_counts=True)
    d_lens[ds_ids // S, ds_ids % S] = ds_cnt

    # cursor keys: (region, digit); every digit of a touched region is a
    # key, since drains visit digits with no deposit too
    dep_key = regions[dep_chunk] * R + dep_digit
    nkeys = (int(regions.max()) + 1) * R
    sim = simulate_cursors(dep_chunk, dep_key, d_lens, nkeys)
    inv_ed = np.empty(nd, np.int64)
    inv_ed[sim.ed] = np.arange(nd)
    has_resid = sim.C.any(axis=1)
    ncyc = sim.cycle + has_resid
    rc_base = np.concatenate([[0], np.cumsum(ncyc)])
    nrc = int(rc_base[-1])

    # ---- phase-ordered descriptor stream (K-rotated digit slots) ----------
    # A digit's global cycle sequence (cumulative across regions: the digit
    # slot is reused region after region) rotates through K slots, so no
    # slot is flushed and deposited again within one step.
    step_of_chunk = np.arange(n_in) // kb
    nregs = int(regions.max()) + 1
    last_pos = np.zeros(nregs, np.int64)
    np.maximum.at(last_pos, regions, np.arange(n_in))
    e_chunk = sim.dc
    e_key = sim.dr
    e_digit = e_key % R
    e_step = step_of_chunk[e_chunk]
    sp_mask = sim.split.astype(bool)
    spw = np.nonzero(sp_mask)[0]

    basecyc = np.concatenate(
        [np.zeros((1, R), np.int64),
         np.cumsum(ncyc.reshape(nregs, R), axis=0)[:-1]]).reshape(-1)
    gc1 = basecyc[e_key] + sim.cyc1
    gc2 = basecyc[e_key] + sim.cyc2
    dr_all = np.nonzero(has_resid)[0]
    dr_gc_all = basecyc[dr_all] + sim.cycle[dr_all]
    er_all = np.zeros(nkeys, np.int64)
    np.maximum.at(er_all, e_key, e_step)

    def _rotation_depth(t_dig, t_step, t_gc):
        """1 + the most distinct global cycles of one digit in one step."""
        gspan = int(t_gc.max()) + 2
        tk = (t_dig * np.int64(nsteps2 + 1) + t_step) * gspan + t_gc
        uk = np.unique(tk)
        _, cnt = np.unique(uk // gspan, return_counts=True)
        return int(cnt.max()) + 1

    # K0: the depth of the unstaggered schedule (splits at their deposit's
    # step, drains at the region's end); it sets the flush windows below
    K0 = _rotation_depth(
        np.concatenate([e_digit, e_digit[spw], dr_all % R]),
        np.concatenate([e_step, e_step[spw],
                        step_of_chunk[last_pos[dr_all // R]]]),
        np.concatenate([gc1, gc2[spw], dr_gc_all]))

    # first deposit step per (digit, global cycle): the reuse horizon
    dd = np.concatenate([e_digit, e_digit[spw]])
    dgc = np.concatenate([gc1, gc2[spw]])
    dstp = np.concatenate([e_step, e_step[spw]])
    gspan0 = int(dgc.max()) + K0 + 2
    fd_key = dd * gspan0 + dgc
    o0 = np.lexsort((dstp, fd_key))
    fk_s = fd_key[o0]
    fst = np.ones(len(fk_s), bool)
    fst[1:] = fk_s[1:] != fk_s[:-1]
    fd_keys_u = fk_s[fst]
    fd_step_u = dstp[o0][fst]

    # every flush (splits + drains) with its [er, dl] window
    fl_er = np.concatenate([e_step[spw], er_all[dr_all]])
    fl_dig = np.concatenate([e_digit[spw], dr_all % R])
    fl_gc = np.concatenate([gc1[spw], dr_gc_all])
    fl_key0 = np.concatenate([e_key[spw], dr_all])
    fl_rc0 = np.concatenate([rc_base[e_key[spw]] + sim.cyc1[spw],
                             rc_base[dr_all] + sim.cycle[dr_all]])
    reuse = fl_dig * gspan0 + fl_gc + K0
    look = np.minimum(np.searchsorted(fd_keys_u, reuse),
                      max(len(fd_keys_u) - 1, 0))
    hit = (fd_keys_u[look] == reuse) if len(fd_keys_u) else \
        np.zeros(len(reuse), bool)
    fl_dl = np.where(hit, fd_step_u[look] - 1, nsteps2 - 1)
    assert (fl_dl >= fl_er).all(), "flush window inverted (K0 violated)"
    forder2, fl_step_all = _schedule_flushes(fl_er, fl_dl, fl_rc0, nsteps2)
    fl_key_all = fl_key0[forder2]
    fl_rc_all = fl_rc0[forder2]
    fl_gc_s = fl_gc[forder2]
    fl_dig_s = fl_dig[forder2]

    # final K: never below K0, raised if the staggered steps need more
    K = max(K0, _rotation_depth(
        np.concatenate([e_digit, e_digit[spw], fl_dig_s]),
        np.concatenate([e_step, e_step[spw], fl_step_all]),
        np.concatenate([gc1, gc2[spw], fl_gc_s])))
    num_slots2 = R * K
    assert num_slots2 <= 4096, \
        f"rotated split slots exceed the 12-bit field ({num_slots2})"
    slot1 = e_digit * K + gc1 % K
    slot2 = e_digit * K + gc2 % K
    fl_slot_all = fl_dig_s * K + fl_gc_s % K

    # deposit pieces in execution order (piece 2 right after its piece 1)
    per_dep = np.where(sp_mask, 2, 1)
    dbase = np.concatenate([[0], np.cumsum(per_dep)[:-1]])
    npc = int(per_dep.sum())
    pc_step = np.zeros(npc, np.int64)
    pc_chunk = np.zeros(npc, np.int64)
    pc_slot = np.zeros(npc, np.int64)
    pc_piece = np.zeros(npc, np.int64)
    pc_step[dbase] = e_step
    pc_chunk[dbase] = e_chunk
    pc_slot[dbase] = slot1
    pc_piece[dbase] = 2 * np.arange(nd)
    pc_step[dbase[spw] + 1] = e_step[spw]
    pc_chunk[dbase[spw] + 1] = e_chunk[spw]
    pc_slot[dbase[spw] + 1] = slot2[spw]
    pc_piece[dbase[spw] + 1] = 2 * spw + 1
    dep_counts = np.bincount(pc_step, minlength=nsteps2)
    dstep2 = max(int(dep_counts.max()), 1)
    dep_first2 = np.concatenate([[0], np.cumsum(dep_counts)[:-1]])
    p_of = np.arange(npc) - dep_first2[pc_step]
    dmax2 = dstep2

    nf = len(fl_step_all)
    fl_counts = np.bincount(fl_step_all, minlength=nsteps2)
    f2 = max(int(fl_counts.max()), 1)
    assert f2 <= 256, f"flush ordinal overflow ({f2})"
    fl_first2 = np.concatenate([[0], np.cumsum(fl_counts)[:-1]])
    q_of = np.arange(nf) - fl_first2[fl_step_all]

    rstep2 = dstep2 + f2
    rg2 = np.zeros((nsteps2, rstep2, 2), np.int32)
    rg2[pc_step, p_of, 0] = ((pc_chunk - pc_step * kb)
                             | (p_of << 8)).astype(np.int32)
    rg2[pc_step, p_of, 1] = (pc_slot | (1 << 15)).astype(np.int32)
    if nf:
        rg2[fl_step_all, dstep2 + q_of, 1] = (
            fl_slot_all | (q_of << 16) | (np.int64(1) << 31)).astype(np.int32)

    piece_sp = np.full((2 * nd, 2), -1, np.int64)   # (step, plane ordinal)
    piece_sp[pc_piece, 0] = pc_step
    piece_sp[pc_piece, 1] = p_of

    # region-cycle -> window-stream position and window
    rc_linear = np.zeros(nrc + 1, np.int64)
    out_pos = fl_step_all * f2 + q_of
    rc_linear[fl_rc_all] = out_pos
    c_win = np.full(nsteps2 * f2, -1, np.int32)
    c_win[out_pos] = fl_key_all.astype(np.int32)   # region*R + digit

    # ---- deposit planes + per-element out positions -----------------------
    el_dep = inv_ed[dep_of_el]                 # execution position
    ds_first = np.concatenate([[0], np.cumsum(ds_cnt)[:-1]])
    el_rank = np.arange(nel) - np.repeat(ds_first, ds_cnt)
    p1 = sim.part1[el_dep, si]
    in_piece1 = el_rank < p1
    el_dst = np.where(in_piece1, sim.dest1[el_dep, si] + el_rank,
                      el_rank - p1)
    el_cyc = np.where(in_piece1, sim.cyc1[el_dep], sim.cyc2[el_dep])
    el_key = e_key[el_dep]
    el_rc = rc_base[el_key] + el_cyc
    el_out = rc_linear[el_rc]                  # window-stream chunk
    piece_idx = 2 * el_dep + (~in_piece1).astype(np.int64)
    pst = piece_sp[piece_idx, 0]
    psl = piece_sp[piece_idx, 1]
    planes2 = np.zeros((nsteps2, dmax2, S, L), np.int8)
    planes2[pst, psl, si, el_dst] = (li - 128).astype(np.int8)

    # ---- reduce streams: per-sublane sort, post-sort rowids, inv ----------
    n_out = nsteps2 * f2
    sk = (el_out * S + si)                     # (out chunk, sublane) group
    sorder = np.lexsort((el_dst, rw, sk))
    sk_s = sk[sorder]
    uniq, first = np.unique(sk_s, return_index=True)
    counts = np.diff(np.concatenate([first, [nel]]))
    spos = np.arange(nel) - np.repeat(first, counts)
    sort2 = np.tile(np.arange(L, dtype=np.int8), (n_out, S, 1))
    sort2[sk_s // S, sk_s % S, spos] = el_dst[sorder].astype(np.int8)
    rowids = np.full((n_out, S, L), 127, np.int8)
    rowids[sk_s // S, sk_s % S, spos] = rw[sorder].astype(np.int8)
    newrun = np.ones(nel, bool)
    newrun[1:] = (sk_s[1:] != sk_s[:-1]) | (rw[sorder][1:] != rw[sorder][:-1])
    run_first = np.nonzero(newrun)[0]
    run_len = np.diff(np.concatenate([run_first, [nel]]))
    run_end_pos = spos[run_first + run_len - 1]
    inv2 = np.zeros((n_out, S, L), np.int8)
    rsk = sk_s[run_first]
    inv2[rsk // S, rsk % S, rw[sorder][run_first]] = \
        (run_end_pos - 128).astype(np.int8)

    # the sort's tail slots read unoccupied lanes (value 0): per (chunk,
    # sublane) the lanes no element lands in, in order
    occ = np.zeros((n_out, S, L), bool)
    occ[el_out, si, el_dst] = True
    cnt_os = occ.sum(axis=2)
    oc_i, os_i, ol_i = np.nonzero(~occ)
    tk = oc_i * S + os_i
    torder = np.argsort(tk, kind="stable")
    tk_s = tk[torder]
    tfirst = np.unique(tk_s, return_index=True)[1]
    tcnt = np.diff(np.concatenate([tfirst, [len(tk_s)]]))
    tpos = np.arange(len(tk_s)) - np.repeat(tfirst, tcnt)
    sort2[tk_s // S, tk_s % S,
          cnt_os[tk_s // S, tk_s % S] + tpos] = ol_i[torder].astype(np.int8)

    in_pad = np.zeros(nsteps2 * kb, np.int32)
    in_pad[:n_in] = in_order.astype(np.int32)

    fill2 = lay.nnz / max(n_out * CHUNK, 1)
    return dict(in_order=in_pad, rg2=rg2, planes2=planes2, c_win=c_win,
                sort2=sort2, rowids=rowids, inv2=inv2,
                num_windows=max(nwin, 1), region_digits=R, kb=kb,
                rstep2=rstep2, f2=f2, dmax2=dmax2, nsteps2=nsteps2,
                dstep2=dstep2, num_slots2=num_slots2, fill2=fill2)


AUTO_TRIPLES_PLANES_BYTES = 2_000_000_000  # "auto": triples only where the
# plane stream would pass 2 GB (orkut-class graphs)
PLANES2_BYTES_PER_NNZ = 30.0   # the planes2 rate of pokec/hollywood-class
# layouts (the JAX package's measured figure; the rule is its own)


def resolve_tropical_split_format(nnz: int, config=None,
                                  split_format: str | None = None) -> str:
    """"planes" or "triples" for a graph of `nnz` entries: `split_format`,
    else the config's `tropical_split_format`; "auto" picks triples where
    the planes would pass AUTO_TRIPLES_PLANES_BYTES."""
    fmt = (getattr(config, "tropical_split_format", "planes")
           if split_format is None else split_format)
    if fmt == "auto":
        return ("triples" if nnz * PLANES2_BYTES_PER_NNZ
                >= AUTO_TRIPLES_PLANES_BYTES else "planes")
    if fmt not in SPLIT_FORMATS:
        raise ValueError(f"unknown split_format {fmt!r}")
    return fmt


def derive_split_triples(lay: PlanarSpMVLayout, parts: dict):
    """Compress the split-pass deposit planes into (sort plane, run words).

    A piece's destinations are one contiguous lane run per sublane, but
    its sources are the lanes of the chunk that hold its digit. Sorting
    each input chunk's sublanes digit-major (stable by (digit, row, lane),
    the order the builder ranks elements in) makes every piece's sources
    contiguous too, so each (piece, sublane) packs into one int32 word
    a0 | d0<<7 | n<<14 (a0: first sorted source lane, d0: first
    destination lane, n: run length) beside one int32 sort plane per input
    chunk. Derived from planes2 and rg2. Returns (xsort2, triples2)."""
    planes2 = parts["planes2"]
    rg2 = parts["rg2"]
    in_pad = np.asarray(parts["in_order"], dtype=np.int64)
    kb = parts["kb"]
    nsteps2, dmax2 = planes2.shape[:2]

    hi = np.asarray(lay.c_hi)[in_pad].astype(np.int64)   # (C, 8, 128)
    lo = np.asarray(lay.c_lo)[in_pad].astype(np.int64)
    C = hi.shape[0]
    lane = np.arange(L, dtype=np.int64)
    invalid = hi < 0
    key = (np.where(invalid, 1, 0) << 24
           | np.where(invalid, 0, hi) << 14
           | np.where(invalid, 0, lo) << 7 | lane)
    xsort = np.argsort(key, axis=2, kind="stable").astype(np.int32)
    sortpos = np.empty((C, S, L), np.int32)
    np.put_along_axis(sortpos, xsort.astype(np.int64),
                      np.broadcast_to(lane.astype(np.int32), (C, S, L)),
                      axis=2)

    # elements: planes2 holds li - 128 in [-128, -1]; 0 is an empty slot
    pst, psl, es, el = np.nonzero(planes2)
    src = planes2[pst, psl, es, el].astype(np.int64) + 128
    cpos = pst.astype(np.int64) * kb + (rg2[pst, psl, 0] & 0xFF)
    sp = sortpos[cpos, es, src].astype(np.int64)
    pk = (pst.astype(np.int64) * dmax2 + psl) * S + es
    npk = nsteps2 * dmax2 * S

    order = np.lexsort((el, pk))
    pk_s, el_s, sp_s = pk[order], el[order], sp[order]
    first = np.ones(len(pk_s), bool)
    first[1:] = pk_s[1:] != pk_s[:-1]
    fi = np.nonzero(first)[0]
    cnt_g = np.diff(np.concatenate([fi, [len(pk_s)]]))
    la = fi + cnt_g - 1
    # the run property the words encode: both ends and the diagonal
    if not (el_s[la] - el_s[fi] + 1 == cnt_g).all():
        raise ValueError("a split piece's destination lanes are not a run")
    if not (sp_s[la] - sp_s[fi] + 1 == cnt_g).all():
        raise ValueError("a split piece's sorted source lanes are not a run")
    diag = np.zeros(npk, np.int64)
    diag[pk_s[fi]] = sp_s[fi] - el_s[fi]
    if not (sp_s - el_s == diag[pk_s]).all():
        raise ValueError("a split piece's source and destination runs "
                         "differ in order")

    a0 = np.zeros(npk, np.int64)
    d0 = np.zeros(npk, np.int64)
    nn = np.zeros(npk, np.int64)
    a0[pk_s[fi]] = sp_s[fi]
    d0[pk_s[fi]] = el_s[fi]
    nn[pk_s[fi]] = cnt_g
    TP2 = max(-(-dmax2 // L), 1)
    triples2 = np.zeros((nsteps2, TP2 * L, S), np.int64)
    words = (a0 | d0 << 7 | nn << 14).reshape(nsteps2, dmax2, S)
    triples2[:, :dmax2, :] = words
    triples2 = triples2.reshape(nsteps2, TP2, L, S) \
                       .transpose(0, 1, 3, 2).astype(np.int32)
    return (xsort.reshape(nsteps2, kb, S, L),
            np.ascontiguousarray(triples2))


def compact_window_stream(parts: dict) -> dict:
    """Pack the rectangular window stream into shared blocks of f2 chunks.

    The split's stream is (nsteps2, f2, 8, 128) with f2 the most flushes
    of any step, far above the average. Consecutive split steps therefore
    share one f2-chunk block until its chunks run out (the monotone block
    map qblk2); a step whose flushes would straddle a block starts the
    next one. Flush words' q becomes the chunk within the step's block,
    and c_win, sort2, rowids and inv2 move with their chunks. Unwritten
    chunks keep inert defaults (c_win -1, identity sort, rowids 127, inv
    0), which the reduce skips like any padding."""
    rg2 = parts["rg2"]
    f2, dstep2, nsteps2 = parts["f2"], parts["dstep2"], parts["nsteps2"]
    w2 = rg2[:, dstep2:, 1].astype(np.int64)
    is_fl = w2 < 0
    n_i = is_fl.sum(axis=1)
    fb = f2
    qblk = np.zeros(nsteps2, np.int32)
    off0 = np.zeros(nsteps2, np.int64)
    cur_blk, cur_off = 0, 0
    for i in range(nsteps2):
        if cur_off + n_i[i] > fb:
            cur_blk += 1
            cur_off = 0
        qblk[i] = cur_blk
        off0[i] = cur_off
        cur_off += n_i[i]
    nblocks = cur_blk + 1

    st, jf = np.nonzero(is_fl)
    old_q = (w2[st, jf] >> 16) & 0xFF
    new_q = off0[st] + old_q            # q is dense 0..n_i-1 within a step
    assert new_q.max(initial=0) < fb <= 256
    w2_new = (w2[st, jf] & ~(0xFF << 16)) | (new_q << 16)
    rg2 = rg2.copy()
    rg2[st, dstep2 + jf, 1] = w2_new.astype(np.int32)

    old_pos = st.astype(np.int64) * f2 + old_q
    new_pos = qblk[st].astype(np.int64) * fb + new_q
    n_out = nblocks * fb
    c_win = np.full(n_out, -1, np.int32)
    c_win[new_pos] = parts["c_win"][old_pos]
    sort2 = np.tile(np.arange(L, dtype=np.int8), (n_out, S, 1))
    sort2[new_pos] = parts["sort2"].reshape(-1, S, L)[old_pos]
    rowids = np.full((n_out, S, L), 127, np.int8)
    rowids[new_pos] = parts["rowids"].reshape(-1, S, L)[old_pos]
    inv2 = np.zeros((n_out, S, L), np.int8)
    inv2[new_pos] = parts["inv2"].reshape(-1, S, L)[old_pos]

    return dict(parts, rg2=rg2, c_win=c_win, sort2=sort2, rowids=rowids,
                inv2=inv2, qblk2=qblk, nblocks2=nblocks,
                fill2=parts["fill2"] * (nsteps2 * f2) / max(n_out, 1))


def pack_tropical(csr: CSRMatrix, config=DEFAULT_CONFIG,
                  region_rows: int | None = None, kb: int = 16,
                  split_format: str | None = None) -> TropicalSpMVLayout:
    """Pack for the tropical engine. Values ride raw, clipped to
    [0, FLOAT_INF], with FLOAT_INF, the tropical annihilator, in empty
    A-value slots; x must be >= 0 (distances). The pass-1 deal is
    `config.planar_deal`; `split_format` overrides
    `config.tropical_split_format`. In the "triples" format the pass-1
    planes are packed to triple-run words too (`planar.triples`,
    `planar.planes` emptied)."""
    work = csr.copy()
    vals = work.adj_data[:work.nnz]
    work.adj_data[:work.nnz] = np.clip(vals, 0.0, FLOAT_INF)
    if region_rows is None:
        region_rows = choose_tropical_region_rows(
            -(-csr.num_rows // 1024) * 1024)
    lay = pack_planar(work, region_rows=region_rows, hi_pad=-1,
                      pad_val=float(FLOAT_INF),
                      deal=config.planar_deal)
    parts = build_split_schedule(lay, kb=kb)
    fmt = resolve_tropical_split_format(csr.nnz, config, split_format)
    if fmt == "triples":
        xsort2, triples2 = derive_split_triples(lay, parts)
        parts = dict(parts, xsort2=xsort2, triples2=triples2,
                     planes2=np.zeros((0, 0, S, L), np.int8))
        lay.triples = planes_to_triples(lay)
        lay.planes = np.zeros((0, 0, S, L), np.int8)
    parts = compact_window_stream(parts)
    return TropicalSpMVLayout(
        planar=lay, num_rows=lay.num_rows, num_cols=lay.num_cols,
        nnz=lay.nnz, **parts)
