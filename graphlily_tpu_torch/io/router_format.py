"""Roll-router SpMV layout (numpy, host side).

The port's copy of the numpy path of `graphlily_tpu/io/router_format.py`:
for every input it builds the same arrays bit for bit (the tests hold the
two equal), so the JAX package's layouts and this one are interchangeable.
`deposit_targets` is new: it turns the descriptor stream's in-order slot
reuse into a per-deposit destination, which lets GPU blocks run the
stream in any order (see ops/router.py).

What the layout means:
  * A-chunk c holds up to 1024 nnz of one 128-column page, row-sorted in
    flat order. Its gathered product is
    g[c, p] = val[c, p] (x) x[a_page[c]*1024 + a_sub[c, p]*128 + a_r[c, p]].
  * rg[t, j] = (w1, w2) for step t. Slots [0, dstep) are deposits, slots
    [dstep, rstep) flushes; w2 == 0 is an inactive slot.
    deposit (w2 > 0): dst = w1 & 0x3FF, delta = ((w1 >> 10) & 0x7F)
      + 128 * ((w1 >> 17) & 7), k = w1 >> 20, slot = w2 & 0xFFF,
      len = w2 >> 16. It copies g[t*cb + k, src + i] into accumulator
      `slot` at dst + i for i < len, where src = (dst - delta) mod 1024.
    flush (w2 < 0): w1 = cursor, slot = w2 & 0xFFF, q = (w2 >> 16) & 0xFF.
      It moves the slot to flush-stream chunk t*f + q and zeroes the slot.
  * Flush-stream chunk s belongs to region c_code[s] (-1: none); its
    element p lands in row c_code[s]*region_rows + c_hi[s, p]*128
    + c_lo[s, p].
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .matrix import CSRMatrix
from .formatter import util_round_csr_matrix_dim

REGION_ROWS = 16384      # max rows per radix region: (128 hi) x (128 lo)
CHUNK = 1024             # elements per (8, 128) chunk
MAX_REGIONS = 512        # accumulator-slot cap of the layout


@dataclasses.dataclass
class RouterSpMVLayout:
    """Static streams and schedules of the roll router (all numpy).
    NSTEPS = steps, CB = A-chunks per step, RSTEP = descriptor slots per
    step, F = flush slots per step."""

    a_r: np.ndarray        # (NSTEPS*CB, 8, 128) int8 : col & 127
    a_sub: np.ndarray      # (NSTEPS*CB, 8, 128) int8 : (col >> 7) & 7
    a_vals: np.ndarray     # (NSTEPS*CB, 8, 128) f32  : values (pad 0)
    a_page: np.ndarray     # (NSTEPS*CB,) int32       : 1024-col tile id
    rg: np.ndarray         # (NSTEPS, RSTEP, 2) int32 : descriptor words
    c_code: np.ndarray     # (NSTEPS*F,) int32 : region per flushed chunk
    c_hi: np.ndarray       # (NSTEPS*F, 8, 128) int8 : (row >> 7) & 127
    c_lo: np.ndarray       # (NSTEPS*F, 8, 128) int8 : row & 127
    num_rows: int
    num_cols: int
    nnz: int
    num_col_tiles: int
    num_regions: int
    region_rows: int
    cb: int
    rstep: int
    f: int
    nsteps: int
    fill_a: float          # nnz / A-chunk slots
    fill_stream: float     # nnz / flush-stream slots
    dstep: int = 0         # deposit slots per step
    num_slots: int = 0     # rotated accumulator slots
    el_slot: np.ndarray | None = None   # (nnz,) original nnz -> a_vals slot

    @property
    def mem_bytes(self) -> int:
        return (self.a_r.nbytes + self.a_sub.nbytes
                + self.a_vals.nbytes + self.a_page.nbytes
                + self.rg.nbytes + self.c_code.nbytes
                + self.c_hi.nbytes + self.c_lo.nbytes
                + self.nsteps * self.f * CHUNK * 4)


def choose_region_rows(nrows: int, ncols: int, nnz: int) -> int:
    """Radix region height: the sqrt optimum of deposit count against
    reduce work, rounded to a multiple of 128 and clamped to
    [1024, 16384] and the MAX_REGIONS cap (same rule as the JAX package,
    so both build the same layout)."""
    npages = max(ncols // 128, 1)
    r_opt = (npages * nrows * 1.0e7 / max(nnz, 1)) ** 0.5
    r = int(round(r_opt / 128)) * 128
    r_min = ((nrows + MAX_REGIONS - 1) // MAX_REGIONS + 127) // 128 * 128
    return max(min(max(r, 1024), REGION_ROWS), r_min)


def _balance_chunks(weight: np.ndarray, nsteps: int, cb: int) -> np.ndarray:
    """Greedy LPT assignment of A-chunks to steps (cb chunks each),
    minimizing the max per-step descriptor weight. Returns the new chunk id
    for each old chunk id."""
    order = np.argsort(-weight, kind="stable")
    heap = [(0, s) for s in range(nsteps)]
    heapq.heapify(heap)
    fill = np.zeros(nsteps, np.int64)
    new_of_old = np.empty(len(weight), np.int64)
    for ci in order:
        w, st = heapq.heappop(heap)
        new_of_old[ci] = st * cb + fill[st]
        fill[st] += 1
        if fill[st] < cb:
            heapq.heappush(heap, (w + int(weight[ci]), st))
    return new_of_old


def pack_router(csr: CSRMatrix, config=None, pad_val: float = 0.0,
                cb: int | None = None,
                region_rows: int | None = None) -> RouterSpMVLayout:
    """Build the router layout and schedules. `pad_val` must be the
    semiring <x> annihilator (0 for arithmetic/logical, the only router
    semirings). `config` is accepted for call-site parity and unused."""
    del config
    assert pad_val == 0.0, "router supports MULADD/ANDOR (pad 0) only"
    work = csr.copy()
    util_round_csr_matrix_dim(work, 1024, 1024)
    nrows, ncols = work.num_rows, work.num_cols
    if region_rows is None:
        region_rows = choose_region_rows(nrows, ncols, work.nnz)
    if cb is None:
        epg = (work.nnz * region_rows
               / max((ncols // 128) * nrows, 1))   # elements per (page, region)
        dpc = 1024 / max(epg, 1.0) + 2.2           # ~descriptors per chunk
        cb = int(min(32, max(8, 256 // dpc)))
    assert cb <= 64, "descriptor field caps cb*1024 source offsets"
    assert region_rows % 128 == 0 and 128 <= region_rows <= REGION_ROWS
    nregions = (nrows + region_rows - 1) // region_rows
    if nregions > MAX_REGIONS:
        raise ValueError(
            f"{nrows} rows -> {nregions} regions exceeds the single-pass "
            f"router limit {MAX_REGIONS}")
    nnz = work.nnz
    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:nnz].astype(np.int64)
    vv = work.adj_data[:nnz].astype(np.float32)

    # ---- A-order: sort by (page, row, col); pack per 128-col page ---------
    page = cc >> 7
    if nrows < (1 << 22) and ncols < (1 << 22):
        key = ((page.astype(np.uint64) << 44)
               | (rr.astype(np.uint64) << 22) | cc.astype(np.uint64))
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((cc, rr, page))
    rr, cc, vv, page = rr[order], cc[order], vv[order], page[order]
    perm = order                      # original element -> current position

    page_ids, pstart, pcount = np.unique(page, return_index=True,
                                         return_counts=True)
    chunks_per_page = (pcount + CHUNK - 1) // CHUNK
    page_chunk_base = np.concatenate([[0], np.cumsum(chunks_per_page)])
    nca = max(int(page_chunk_base[-1]), 1)
    rank = np.arange(nnz, dtype=np.int64) - np.repeat(pstart, pcount)
    pidx = np.searchsorted(page_ids, page)
    a_chunk = page_chunk_base[pidx] + rank // CHUNK
    a_flat = rank % CHUNK
    chunk_page = (np.repeat(page_ids, chunks_per_page).astype(np.int32)
                  if len(page_ids) else np.zeros(nca, np.int32))

    # ---- balance A-chunks across steps by descriptor weight ---------------
    region = (rr // region_rows).astype(np.int64)
    nsteps_deposit = (nca + cb - 1) // cb
    if nnz and nsteps_deposit > 1:
        trans = np.zeros(nca, np.int64)
        same = a_chunk[1:] == a_chunk[:-1]
        np.add.at(trans, a_chunk[1:][same & (region[1:] != region[:-1])], 1)
        weight = trans + 2                       # runs + ~flush share
        new_of_old = _balance_chunks(weight, nsteps_deposit, cb)
        a_chunk = new_of_old[a_chunk]
        cp = np.zeros(nsteps_deposit * cb, np.int32)
        cp[new_of_old] = chunk_page
        chunk_page = cp
        order2 = np.lexsort((a_flat, a_chunk))
        rr, cc, vv = rr[order2], cc[order2], vv[order2]
        a_chunk, a_flat = a_chunk[order2], a_flat[order2]
        region = region[order2]
        perm = perm[order2]
    elif len(chunk_page) < nsteps_deposit * cb:
        chunk_page = np.concatenate(
            [chunk_page,
             np.zeros(nsteps_deposit * cb - len(chunk_page), np.int32)])

    # ---- ranges: runs of equal region within each A-chunk ----------------
    if nnz:
        newrun = np.ones(nnz, bool)
        newrun[1:] = (a_chunk[1:] != a_chunk[:-1]) | (region[1:] != region[:-1])
        run_start = np.nonzero(newrun)[0]
        run_len = np.diff(np.concatenate([run_start, [nnz]]))
        run_chunk = a_chunk[run_start]
        run_src = a_flat[run_start]
        run_region = region[run_start]
    else:
        run_start = run_len = run_chunk = run_src = run_region = \
            np.zeros(0, np.int64)
    nrun = len(run_start)

    # ---- per-region cursor simulation -------------------------------------
    r_sorted = np.lexsort((np.arange(nrun), run_region))   # stable by region
    reg_s = run_region[r_sorted]
    len_s = run_len[r_sorted]
    if nrun:
        cum = np.cumsum(len_s)
        cum_excl = cum - len_s
        seg_start = np.searchsorted(reg_s, np.unique(reg_s))
        seg_sizes = np.diff(np.concatenate([seg_start, [nrun]]))
        start_pos = cum_excl - np.repeat(cum_excl[seg_start], seg_sizes)
    else:
        start_pos = np.zeros(0, np.int64)

    first_fill = np.minimum(len_s, CHUNK - (start_pos % CHUNK))
    needs_split = first_fill < len_s
    d_count = 1 + needs_split.astype(np.int64)
    nd_total = int(d_count.sum())
    d_of = np.repeat(np.arange(nrun), d_count)
    piece = np.zeros(nd_total, np.int64)   # 0 = first piece, 1 = split tail
    if nrun:
        firsts = np.concatenate([[0], np.cumsum(d_count)[:-1]])
        piece[firsts[needs_split] + 1] = 1
    d_len = np.where(piece == 0, first_fill[d_of],
                     len_s[d_of] - first_fill[d_of])
    d_src = run_src[r_sorted][d_of] + np.where(piece == 1, first_fill[d_of], 0)
    d_elem = start_pos[d_of] + np.where(piece == 1, first_fill[d_of], 0)
    d_dst = d_elem % CHUNK
    d_cir = d_elem // CHUNK                 # chunk-in-region
    d_region = reg_s[d_of]
    d_chunk = run_chunk[r_sorted][d_of]
    d_step = d_chunk // cb
    d_src13 = (d_chunk % cb) * CHUNK + d_src

    reg_elems = np.zeros(nregions, np.int64)
    if nrun:
        np.add.at(reg_elems, reg_s, len_s)
    reg_chunks = (reg_elems + CHUNK - 1) // CHUNK
    reg_base = np.concatenate([[0], np.cumsum(reg_chunks)])
    nrc = int(reg_base[-1])                 # real region-chunks
    d_rc = reg_base[d_region] + d_cir

    # ---- descriptor stream (deposits + flushes) ---------------------------
    if nd_total:
        exec_order = np.lexsort((d_src13, d_step))
        e_step = d_step[exec_order]
        e_src = d_src13[exec_order] % CHUNK
        e_k = d_src13[exec_order] // CHUNK
        e_dst = d_dst[exec_order]
        e_delta = (e_dst - e_src) % CHUNK
        e_w1 = (e_dst | ((e_delta % 128) << 10) | ((e_delta // 128) << 17)
                | (e_k << 20)).astype(np.int64)
        e_topping = (d_dst[exec_order] + d_len[exec_order]) == CHUNK
        e_rc = d_rc[exec_order]
        rc_cursor = np.zeros(nrc + 1, np.int64)
        np.maximum.at(rc_cursor, d_rc, d_dst + d_len)
    else:
        e_step = e_w1 = e_rc = np.zeros(0, np.int64)
        e_topping = np.zeros(0, bool)
        rc_cursor = np.zeros(nrc + 1, np.int64)

    # ---- K-rotated accumulator slots ---------------------------------------
    # A step's deposits all run before its flushes, so each region's cycles
    # rotate through K_r slots, K_r > the distinct cycles any one step
    # deposits into.
    if nd_total:
        cir_span = int(d_cir.max()) + 2
        key = ((d_region * np.int64(nsteps_deposit + 1) + d_step)
               * cir_span + d_cir)
        uk = np.unique(key)
        urs = uk // cir_span                    # (region, step) composite
        uk2, cnt = np.unique(urs, return_counts=True)
        kmax = np.ones(nregions, np.int64)
        np.maximum.at(kmax, uk2 // np.int64(nsteps_deposit + 1), cnt)
        K = kmax + 1
    else:
        K = np.full(nregions, 2, np.int64)
    slot_base = np.concatenate([[0], np.cumsum(K)])
    num_slots = int(slot_base[-1])
    assert num_slots <= 4096, \
        f"rotated accumulator slots exceed the 12-bit field ({num_slots})"
    if nd_total:
        e_slot = (slot_base[d_region] + d_cir % K[d_region])[exec_order]
        e_w2 = (e_slot | (d_len[exec_order] << 16)).astype(np.int64)
    else:
        e_slot = e_w2 = np.zeros(0, np.int64)

    # drains: region-chunks whose final cursor < 1024 (each region's last)
    drain_rc = np.nonzero(rc_cursor[:nrc] < CHUNK)[0] if nrc else \
        np.zeros(0, np.int64)
    n_drain = len(drain_rc)
    drain_per_step = cb + 2
    n_drain_steps = (n_drain + drain_per_step - 1) // drain_per_step
    nsteps = nsteps_deposit + n_drain_steps

    nd = len(e_step)
    n_top = int(e_topping.sum())
    dep_counts = (np.bincount(e_step, minlength=nsteps)
                  if nd else np.zeros(nsteps, np.int64))
    dstep = max(int(dep_counts.max()) if nd else 0, 1)
    dep_first = np.concatenate([[0], np.cumsum(dep_counts)[:-1]])
    dep_rank = (np.arange(nd) - dep_first[e_step]) if nd else e_step

    dr_region = (np.searchsorted(reg_base, drain_rc, side="right") - 1
                 if n_drain else np.zeros(0, np.int64))
    fl_step = np.concatenate([
        e_step[e_topping],
        nsteps_deposit + np.arange(n_drain) // drain_per_step]).astype(
            np.int64)
    fl_w1 = np.concatenate([np.full(n_top, CHUNK, np.int64),
                            rc_cursor[drain_rc]])
    fl_slot = np.concatenate([
        e_slot[e_topping],
        slot_base[dr_region] + (drain_rc - reg_base[dr_region])
        % K[dr_region]]) if (n_top + n_drain) else np.zeros(0, np.int64)
    fl_rc = np.concatenate([e_rc[e_topping], drain_rc])
    nf = len(fl_step)
    fl_counts = (np.bincount(fl_step, minlength=nsteps)
                 if nf else np.zeros(nsteps, np.int64))
    f_max = max(int(fl_counts.max()) if nf else 0, 1)
    assert f_max <= 256, f"flush ordinal overflow ({f_max} > 8 bits)"
    fl_first = np.concatenate([[0], np.cumsum(fl_counts)[:-1]])
    q_of = (np.arange(nf) - fl_first[fl_step]) if nf else fl_step

    rstep = dstep + f_max
    rg = np.zeros((nsteps, rstep, 2), np.int32)
    if nd:
        rg[e_step, dep_rank, 0] = e_w1.astype(np.int32)
        rg[e_step, dep_rank, 1] = e_w2.astype(np.int32)
    if nf:
        rg[fl_step, dstep + q_of, 0] = fl_w1.astype(np.int32)
        rg[fl_step, dstep + q_of, 1] = (
            fl_slot | (q_of << 16) | (np.int64(1) << 31)).astype(np.int32)

    # pad the step count so the flush stream (nsteps * f chunks) is a
    # multiple of cb, as the JAX layout does
    f = f_max
    for k in range(cb + 1):
        if ((nsteps + k) * f) % cb == 0:
            nsteps += k
            break
    else:
        raise AssertionError("no step padding aligns the flush stream")
    if rg.shape[0] < nsteps:
        rg = np.concatenate(
            [rg, np.zeros((nsteps - rg.shape[0], rstep, 2), np.int32)])

    # region-chunk -> flush stream position
    c_code = np.full(nsteps * f, -1, np.int32)
    rc_linear = np.zeros(nrc + 1, np.int64)
    if nf:
        rc_linear[fl_rc] = fl_step * f + q_of
        c_code[rc_linear[fl_rc]] = (
            np.searchsorted(reg_base, fl_rc, side="right") - 1)

    # ---- A streams (padded to the full grid) ------------------------------
    ncap = nsteps * cb
    a_r = np.zeros((ncap, 8, 128), np.int8)
    a_vals = np.zeros((ncap, 8, 128), np.float32)
    a_page_arr = np.zeros(ncap, np.int32)
    a_r[a_chunk, a_flat // 128, a_flat % 128] = (cc & 127).astype(np.int8)
    a_vals[a_chunk, a_flat // 128, a_flat % 128] = vv
    el_slot = np.empty(nnz, np.int64)
    el_slot[perm] = a_chunk * CHUNK + a_flat
    a_page_arr[:len(chunk_page)] = chunk_page >> 3
    # the sublane plane holds the chunk-constant page % 8 at every slot,
    # padding included
    a_sub = np.zeros((ncap, 8, 128), np.int8)
    a_sub[:len(chunk_page)] = (chunk_page & 7).astype(np.int8)[:, None, None]

    # ---- reduce-side streams -----------------------------------------------
    c_hi = np.zeros((nsteps * f, 8, 128), np.int8)
    c_lo = np.zeros((nsteps * f, 8, 128), np.int8)
    if nnz:
        r_first = np.concatenate([[0], np.cumsum(run_len)[:-1]])
        within = np.arange(nnz, dtype=np.int64) - np.repeat(r_first, run_len)
        inv_rs = np.empty(nrun, np.int64)
        inv_rs[r_sorted] = np.arange(nrun)
        elem_rpos = start_pos[inv_rs].repeat(run_len) + within
        elem_rc = reg_base[region] + elem_rpos // CHUNK
        elem_pos = rc_linear[elem_rc] * CHUNK + elem_rpos % CHUNK
        oc, of = elem_pos // CHUNK, elem_pos % CHUNK
        row_in_reg = rr % region_rows
        c_hi[oc, of // 128, of % 128] = (row_in_reg >> 7).astype(np.int8)
        c_lo[oc, of // 128, of % 128] = (row_in_reg & 127).astype(np.int8)

    return RouterSpMVLayout(
        a_r=a_r, a_sub=a_sub, a_vals=a_vals, a_page=a_page_arr,
        rg=rg, c_code=c_code, c_hi=c_hi, c_lo=c_lo,
        num_rows=nrows, num_cols=ncols, nnz=nnz,
        num_col_tiles=ncols // 1024, num_regions=nregions,
        region_rows=region_rows,
        cb=cb, rstep=rstep, f=f, nsteps=nsteps,
        fill_a=nnz / max(nca * CHUNK, 1),
        fill_stream=nnz / max(nsteps * f * CHUNK, 1),
        dstep=dstep, num_slots=num_slots,
        el_slot=el_slot,
    )


def deposit_targets(rg: np.ndarray, dstep: int, f: int,
                    block: np.ndarray | None = None) -> np.ndarray:
    """Flush-stream chunk each deposit lands in: (nsteps, dstep) int32,
    -1 for inactive slots.

    The descriptor stream reuses accumulator slots in stream order (step
    by step; within a step all deposits precede all flushes). A deposit's
    elements leave its slot at the first flush of the same slot after it,
    so target[t, j] = t_f * f + q_f of that flush. `block` (nsteps,) maps
    a step to the stream block its flushes land in, f chunks each: the
    tropical compact window stream, whose flush q of step t lands in chunk
    block[t] * f + q (io/tropical_format.compact_window_stream). With the
    target known, every deposit is an independent copy and the stream can
    run in any order. Raises if a deposit is never flushed (a malformed
    layout)."""
    rg = np.asarray(rg)
    nsteps, rstep, _ = rg.shape
    w2 = rg[..., 1].astype(np.int64)
    target = np.full((nsteps, dstep), -1, np.int32)
    dt, dj = np.nonzero(w2[:, :dstep] > 0)
    if dt.size == 0:
        return target
    d_slot = w2[dt, dj] & 0xFFF
    ft, fj = np.nonzero(w2[:, dstep:] < 0)
    f_w2 = w2[ft, fj + dstep]
    f_slot = f_w2 & 0xFFF
    f_q = (f_w2 >> 16) & 0xFF
    m = np.int64(nsteps) * rstep
    f_key = f_slot * m + ft * rstep + (fj + dstep)
    order = np.argsort(f_key, kind="stable")
    f_key = f_key[order]
    d_key = d_slot * m + dt * rstep + dj
    hit = np.searchsorted(f_key, d_key, side="right")
    ok = hit < len(f_key)
    ok[ok] = (f_key[hit[ok]] // m) == d_slot[ok]
    if not ok.all():
        raise ValueError(f"{int((~ok).sum())} deposits have no later flush "
                         "of their slot")
    fo = order[hit]
    blk = ft[fo] if block is None else np.asarray(block, np.int64)[ft[fo]]
    target[dt, dj] = (blk * f + f_q[fo]).astype(np.int32)
    return target
