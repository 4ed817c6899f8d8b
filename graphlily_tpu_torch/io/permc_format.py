"""PERM-C planar layout (numpy, host side).

The port's copy of `graphlily_tpu/io/permc_format.py`: with
`native=False` it builds the same arrays bit for bit (the tests hold the
two equal), so either package's PERM-C layout drives the port's
`PlanarSpMV`. With `native=True` (the default) the element-wise greedy
runs in the port's C++ copy (graphlily_tpu_torch/native), bit-identical
to `_greedy_permc_py` and fast enough for the full pokec stand-in; a
failed build raises.

PERM-C re-deals each element's (sublane, region cycle) under three
constraints:
  claims    per (chunk, sublane, class rho = col & 127) one source sublane
            sig = (col >> 7) & 7, the chained gather's rule (deal "free");
  capacity  128 A-lanes per (chunk, sublane);
  perm-c    within every (region cycle, sublane) at most one row per
            lo = row & 127, and each row's deposits form one contiguous
            accumulator run, with a `depth`-cycle live window per region
            (K-rotated accumulator slots keep the window live). When no
            cycle of the window can take an element, the region's oldest
            cycle flushes.
Deposits ship as triple-run words (one int32 per (piece, sublane),
a0 | d0<<7 | n<<14), never as (8, 128) planes. Phase C is keyed by
DESTINATION lane v = row & 127: in flushed chunk q, sublane s, the row
at lane v owns accumulator lanes (c_beg[q, s, v], c_end[q, s, v]] and
sits at c_hi[q, s, v] within its region; unused lanes hold
hi = end = beg = 0. `c_lo` is empty and `planes` has no plane.
MULADD/ANDOR only.

`permc_stream_rows` re-keys those streams by stream position, the form
the "free" deal's c_hi/c_lo have, so K4 fused, K4p fused and the plain
versions read a PERM-C layout unchanged.
"""
from __future__ import annotations

import numpy as np

from .matrix import CSRMatrix
from .formatter import util_round_csr_matrix_dim
from .router_format import CHUNK, MAX_REGIONS, _balance_chunks
from .planar_format import S, L, PlanarSpMVLayout, choose_planar_region_rows


def _greedy_permc_py(tile, rho, sig, row, region, lo, ntiles, nregions,
                     depth, chunk_of=None, nca_in=0, spill_cb=8):
    """Reference element-wise greedy (numpy; the C++ copy in
    graphlily_tpu_torch/native is bit-identical). Elements arrive
    (tile, row, col) sorted. Returns per-element (a_chunk, sub, cyc, pos),
    the chunk count and the flush and drain event logs.

    Execution order = chunk id order. Pass 1 (chunk_of None): per tile,
    1024-element rank windows of the (row, col)-sorted pending list;
    elements that cannot be placed (claims or capacity exhausted)
    re-window into fresh chunks of the same tile until none remain.
    Pass 2 (chunk_of given): the LPT-balanced renumbering of pass 1's
    chunks; residual spills trail, K chunks per step."""
    n = len(tile)
    a_chunk = np.full(n, -1, np.int64)
    sub_of = np.zeros(n, np.int64)
    cyc_of = np.zeros(n, np.int64)
    pos_of = np.zeros(n, np.int64)

    cursor = np.zeros((nregions, depth, S), np.int32)
    lo_owner = np.full((nregions, depth, S, L), -1, np.int64)
    last_row = np.full((nregions, depth, S), -1, np.int64)
    cycle = np.zeros(nregions, np.int64)

    fl_chunk: list[int] = []
    fl_region: list[int] = []
    fl_cycle: list[int] = []

    def flush(r, ch):
        fl_chunk.append(ch)
        fl_region.append(int(r))
        fl_cycle.append(int(cycle[r]))
        cursor[r, :-1] = cursor[r, 1:]
        cursor[r, -1] = 0
        lo_owner[r, :-1] = lo_owner[r, 1:]
        lo_owner[r, -1] = -1
        last_row[r, :-1] = last_row[r, 1:]
        last_row[r, -1] = -1
        cycle[r] += 1

    if chunk_of is not None:
        # a stable sort keeps pass 1's element order within each chunk
        eo = np.argsort(chunk_of, kind="stable")
        groups: list[tuple[int, np.ndarray]] = []
        if n:
            bounds = np.nonzero(np.concatenate(
                [[True], chunk_of[eo][1:] != chunk_of[eo][:-1]]))[0]
            ids = chunk_of[eo[bounds]]
            ends = np.concatenate([bounds[1:], [n]])
            groups = [(int(ids[g]), eo[bounds[g]:ends[g]])
                      for g in range(len(bounds))]
        work_iter = groups
    else:
        work_iter = None

    next_chunk = 0
    tstart = np.concatenate([[0], np.cumsum(np.bincount(
        tile, minlength=ntiles))])

    def place_chunk(ch, elems):
        claims = np.full((S, L), -1, np.int8)
        alane = np.zeros(S, np.int32)
        nxt = []
        for i in elems:
            r = region[i]
            h = rho[i]
            g = sig[i]
            v = lo[i]
            rw = row[i]
            placed = False
            for attempt in (0, 1):
                best_d = best_s = -1
                best_cost = 1 << 30
                claim_ok = False
                for s in range(S):
                    cl = claims[s, h]
                    if (cl != -1 and cl != g) or alane[s] >= L:
                        continue
                    claim_ok = True
                    for d in range(depth):
                        cu = cursor[r, d, s]
                        if cu >= L:
                            continue
                        own = lo_owner[r, d, s, v]
                        if own == rw:
                            if last_row[r, d, s] != rw:
                                continue   # run closed: no reopen
                        elif own != -1:
                            continue
                        cost = d * 1000 + cu
                        if cost < best_cost:
                            best_d, best_s = d, s
                            best_cost = cost
                        break   # earlier cycle preferred per s
                if best_s >= 0:
                    claims[best_s, h] = g
                    alane[best_s] += 1
                    pos_of[i] = cursor[r, best_d, best_s]
                    cursor[r, best_d, best_s] += 1
                    lo_owner[r, best_d, best_s, v] = rw
                    last_row[r, best_d, best_s] = rw
                    a_chunk[i] = ch
                    sub_of[i] = best_s
                    cyc_of[i] = cycle[r] + best_d
                    placed = True
                    break
                if attempt == 0 and claim_ok:
                    flush(r, ch)
                    continue
                break
            if not placed:
                nxt.append(i)
        return nxt

    def run_rounds(pend, alloc):
        guard = 0
        while pend:
            guard += 1
            assert guard < 64, "permc spill recursion exceeded 64 rounds"
            nxt: list[int] = []
            for w0 in range(0, len(pend), CHUNK):
                nxt.extend(place_chunk(alloc(), pend[w0:w0 + CHUNK]))
            pend = nxt

    state = {"j": 0}

    def alloc_seq():
        ch = next_chunk + state["j"]
        state["j"] += 1
        return ch

    if work_iter is not None:             # pass 2: prescribed chunks
        spilled: list[int] = []
        for ch, elems in work_iter:
            spilled.extend(place_chunk(ch, elems))
        # residual spill chunks trail, K per step: a spill window's rows
        # span the whole matrix, so cb of them in one step would blow dstep
        next_chunk = nca_in
        cb_ = max(spill_cb, 1)
        K = max(1, cb_ // 8)

        def alloc_spaced():
            j = state["j"]
            state["j"] += 1
            return next_chunk + (j // K) * cb_ + (j % K)

        spilled.sort()                    # (tile, row, col) order
        sp_tile = {}
        for i in spilled:
            sp_tile.setdefault(int(tile[i]), []).append(i)
        for t in sorted(sp_tile):
            run_rounds(sp_tile[t], alloc_spaced)
        nspill = state["j"]
        nca = max(nca_in + ((nspill + K - 1) // K) * cb_ if nspill else
                  nca_in, 1)
    else:                                 # pass 1: windowing + spill rounds
        for t in range(ntiles):
            run_rounds(list(range(int(tstart[t]), int(tstart[t + 1]))),
                       alloc_seq)
        nca = max(next_chunk + state["j"], 1)

    # end drain: remaining window cycles flush in trailing steps
    dr_region: list[int] = []
    dr_cycle: list[int] = []
    for r in range(nregions):
        for d in range(depth):
            if cursor[r, d].sum() > 0:
                dr_region.append(r)
                dr_cycle.append(int(cycle[r] + d))
    assert (a_chunk >= 0).all()
    return (a_chunk, sub_of, cyc_of, pos_of, nca,
            np.asarray(fl_chunk, np.int64), np.asarray(fl_region, np.int64),
            np.asarray(fl_cycle, np.int64),
            np.asarray(dr_region, np.int64), np.asarray(dr_cycle, np.int64))


def pack_permc(csr: CSRMatrix, config=None, pad_val: float = 0.0,
               cb: int | None = None, region_rows: int | None = None,
               depth: int = 4, native: bool = True) -> PlanarSpMVLayout:
    """Pack `csr` into a PERM-C planar layout: triple-run deposits and the
    destination-lane-keyed phase-C streams c_hi/c_end/c_beg (no planes,
    no c_lo). `native` runs the greedy in C++ (built at first use; a
    failed build raises), `native=False` in numpy. `config` is accepted
    for call-site parity and unused."""
    del config
    work = csr.copy()
    util_round_csr_matrix_dim(work, 1024, 1024)
    nrows, ncols = work.num_rows, work.num_cols
    if region_rows is None:
        region_rows = choose_planar_region_rows(nrows, ncols, work.nnz)
    assert region_rows % 128 == 0
    nregions = (nrows + region_rows - 1) // region_rows
    if nregions > MAX_REGIONS:
        raise ValueError(f"{nrows} rows -> {nregions} regions exceeds "
                         f"the planar router limit {MAX_REGIONS}")
    nnz = work.nnz
    ntiles = ncols // 1024
    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:nnz].astype(np.int64)
    vv = work.adj_data[:nnz].astype(np.float32)
    order = np.lexsort((cc, rr, cc >> 10))
    rr, cc, vv = rr[order], cc[order], vv[order]
    tile = cc >> 10
    rho = (cc & 127).astype(np.int64)
    sig = ((cc >> 7) & 7).astype(np.int64)
    region = rr // region_rows
    lo = (rr & 127).astype(np.int64)
    if native and nnz:
        from ..native import permc_greedy as greedy_fn
    else:
        greedy_fn = _greedy_permc_py

    def greedy(chunk_of=None, nca_in=0, spill_cb=8):
        return greedy_fn(tile, rho, sig, rr, region, lo, ntiles, nregions,
                         depth, chunk_of=chunk_of, nca_in=nca_in,
                         spill_cb=spill_cb)

    # pass 1 discovers the chunking and exact per-chunk item counts; the
    # LPT renumbering evens the per-step descriptor load (dstep); pass 2
    # re-runs the greedy in balanced chunk order
    (a_chunk, sub_of, cyc_of, pos_of, nca,
     fl_chunk, fl_region, fl_cycle, dr_region, dr_cycle) = greedy()
    if nnz and nca > 1:
        maxc1 = int(cyc_of.max()) + 1
        pk1 = np.unique((a_chunk * nregions + region) * maxc1 + cyc_of)
        nd1 = len(pk1)
        items = (1 + np.bincount(pk1 // (nregions * maxc1),
                                 minlength=nca)
                 + np.bincount(fl_chunk, minlength=nca)[:nca])
        if cb is None:
            dpc = nd1 / max(nca, 1) + 2.0
            cb = int(min(32, max(8, 256 // dpc)))
        nsteps_dep = (nca + cb - 1) // cb
        if nsteps_dep > 1:
            new_of_old = _balance_chunks(items, nsteps_dep, cb)
            (a_chunk, sub_of, cyc_of, pos_of, nca,
             fl_chunk, fl_region, fl_cycle, dr_region, dr_cycle) = greedy(
                chunk_of=new_of_old[a_chunk], nca_in=nsteps_dep * cb,
                spill_cb=cb)

    return _pack_permc_tail(
        rr, cc, vv, order, a_chunk, sub_of, cyc_of, pos_of, nca,
        fl_chunk, fl_region, fl_cycle, dr_region, dr_cycle,
        nrows, ncols, nnz, region_rows, nregions, ntiles, cb, pad_val)


def _pack_permc_tail(rr, cc, vv, order, a_chunk, sub_of, cyc_of, pos_of,
                     nca, fl_chunk, fl_region, fl_cycle, dr_region,
                     dr_cycle, nrows, ncols, nnz, region_rows, nregions,
                     ntiles, cb, pad_val):
    region = rr // region_rows

    # ---- A-lane assignment: pieces contiguous per (chunk, sublane) -------
    # sorting by (chunk, sub, region, cycle, pos) makes every (piece,
    # sublane) one contiguous ascending A-run, and its accumulator run is
    # contiguous ascending by construction (cursor order)
    eo = np.lexsort((pos_of, cyc_of, region, sub_of, a_chunk))
    a_chunk_s = a_chunk[eo]
    sub_s = sub_of[eo]
    cyc_s = cyc_of[eo]
    pos_s = pos_of[eo]
    reg_s = region[eo]
    ks = a_chunk_s * S + sub_s
    new = np.ones(nnz, bool)
    if nnz:
        new[1:] = ks[1:] != ks[:-1]
    gs = np.nonzero(new)[0] if nnz else np.zeros(0, np.int64)
    a_lane = (np.arange(nnz) - np.repeat(
        gs, np.diff(np.concatenate([gs, [nnz]])))) if nnz else \
        np.zeros(0, np.int64)
    assert not nnz or a_lane.max() < L

    # ---- pieces: one triple set per (chunk, region, cycle) ---------------
    maxcyc = int(cyc_s.max()) + 1 if nnz else 1
    pk = (a_chunk_s * nregions + reg_s) * maxcyc + cyc_s
    upk, pidx = np.unique(pk, return_inverse=True) if nnz else \
        (np.zeros(0, np.int64), np.zeros(0, np.int64))
    nd = len(upk)
    p_chunk = upk // (nregions * maxcyc)
    p_region = (upk // maxcyc) % nregions
    p_cycle = upk % maxcyc

    # chunk -> step
    if cb is None:
        dpc = nd / max(nca, 1) + 2.0
        cb = int(min(32, max(8, 256 // dpc)))
    nsteps_dep = (nca + cb - 1) // cb
    p_step = p_chunk // cb

    # per-step deposit ordinals (pieces are in (step, chunk, ...) order:
    # the chunk is the key's high part)
    dep_counts = np.bincount(p_step, minlength=nsteps_dep) if nd else \
        np.zeros(nsteps_dep, np.int64)
    dstep = max(int(dep_counts.max()) if nd else 0, 1)
    dep_first = np.concatenate([[0], np.cumsum(dep_counts)[:-1]])
    p_of = (np.arange(nd) - dep_first[p_step]) if nd else \
        np.zeros(0, np.int64)

    # ---- flushes: events in their chunk's step + trailing drains ---------
    n_drain = len(dr_region)
    drain_per_step = cb + 2
    n_drain_steps = (n_drain + drain_per_step - 1) // drain_per_step
    nsteps = nsteps_dep + n_drain_steps
    fl_step = np.concatenate([
        fl_chunk // cb,
        nsteps_dep + np.arange(n_drain) // drain_per_step]).astype(np.int64)
    fl_reg = np.concatenate([fl_region, dr_region])
    fl_cyc = np.concatenate([fl_cycle, dr_cycle])
    # event order within a step is execution order (fl_chunk ascending,
    # drains appended)
    nf = len(fl_step)
    fl_counts = (np.bincount(fl_step, minlength=nsteps) if nf
                 else np.zeros(nsteps, np.int64))
    f = max(int(fl_counts.max()) if nf else 0, 1)
    assert f <= 256, f"flush ordinal overflow ({f})"
    fl_first = np.concatenate([[0], np.cumsum(fl_counts)[:-1]])
    q_of = (np.arange(nf) - fl_first[fl_step]) if nf else fl_step

    # ---- K-rotated accumulator slots --------------------------------------
    # all cycles of a region touched within one step (deposits and
    # flushes) map to distinct slots: K[r] = 1 + max step-span
    if nd or nf:
        t_reg = np.concatenate([p_region, fl_reg])
        t_step = np.concatenate([p_step, fl_step])
        t_cyc = np.concatenate([p_cycle, fl_cyc])
        key = t_reg * np.int64(nsteps + 1) + t_step
        kmin = np.full(nregions * np.int64(nsteps + 1), 1 << 60, np.int64)
        kmax = np.full(nregions * np.int64(nsteps + 1), -1, np.int64)
        np.minimum.at(kmin, key, t_cyc)
        np.maximum.at(kmax, key, t_cyc)
        span = np.where(kmax >= 0, kmax - kmin + 1, 0).reshape(
            nregions, nsteps + 1)
        K = span.max(axis=1) + 1
        K = np.maximum(K, 2)
    else:
        K = np.full(nregions, 2, np.int64)
    slot_base = np.concatenate([[0], np.cumsum(K)])
    num_slots = int(slot_base[-1])
    assert num_slots <= 4096, \
        f"rotated accumulator slots exceed the 12-bit field ({num_slots})"

    # ---- descriptor stream -------------------------------------------------
    rstep = dstep + f
    rg = np.zeros((nsteps, rstep, 2), np.int32)
    if nd:
        p_slot = slot_base[p_region] + p_cycle % K[p_region]
        rg[p_step, p_of, 0] = (p_chunk % cb | (p_of << 8)).astype(np.int32)
        rg[p_step, p_of, 1] = (p_slot | (1 << 15)).astype(np.int32)
    if nf:
        f_slot = slot_base[fl_reg] + fl_cyc % K[fl_reg]
        rg[fl_step, dstep + q_of, 1] = (
            f_slot | (q_of << 16) | (np.int64(1) << 31)).astype(np.int32)

    # ---- triple-run deposit words -------------------------------------------
    TP = (dstep + L - 1) // L
    triples = np.zeros((nsteps, TP, S, L), np.int32)
    if nnz:
        # per (piece, sublane): a0 = first a_lane, d0 = first pos, n; pidx
        # is not monotone in eo order, so group through an argsort
        ps_key = pidx * S + sub_s
        po = np.argsort(ps_key, kind="stable")
        psk_s = ps_key[po]
        newps = np.ones(nnz, bool)
        newps[1:] = psk_s[1:] != psk_s[:-1]
        firsts = np.nonzero(newps)[0]
        ups = psk_s[firsts]
        cnt = np.diff(np.concatenate([firsts, [nnz]]))
        el0 = po[firsts]
        u_piece = ups // S
        u_sub = ups % S
        a0 = a_lane[el0]
        d0 = pos_s[el0]
        ell = po[firsts + cnt - 1]
        assert (pos_s[ell] == d0 + cnt - 1).all(), \
            "piece accumulator run not contiguous"
        assert (a_lane[ell] == a0 + cnt - 1).all(), \
            "piece A-run not contiguous"
        word = (a0 | (d0 << 7) | (cnt << 14)).astype(np.int32)
        st = p_step[u_piece]
        sl = p_of[u_piece]
        triples[st, sl >> 7, u_sub, sl & 127] = word

    # ---- phase-C streams: c_code + dest-lane-keyed hi/end/beg --------------
    c_code = np.full(nsteps * f, -1, np.int32)
    c_hi = np.zeros((nsteps * f, S, L), np.int8)
    c_end = np.zeros((nsteps * f, S, L), np.int8)
    c_beg = np.zeros((nsteps * f, S, L), np.int8)
    if nf:
        rc_key = fl_reg * np.int64(np.max(fl_cyc) + 1 if nf else 1) + fl_cyc
        ocs = fl_step * f + q_of
        c_code[ocs] = fl_reg.astype(np.int32)
        rc_order = np.argsort(rc_key)   # one flush per region cycle: unique
        rc_sorted = rc_key[rc_order]
        # row runs: group by (region, cycle, sublane, row); a row's run may
        # span pieces (consecutive chunks) but stays contiguous in pos
        if nnz:
            row_s = rr[eo]
            rk = ((reg_s * np.int64(np.max(fl_cyc) + 1) + cyc_s) * S
                  + sub_s)
            ro = np.lexsort((pos_s, rk))
            rk_s = rk[ro]
            row_ss = row_s[ro]
            newr = np.ones(nnz, bool)
            newr[1:] = (rk_s[1:] != rk_s[:-1]) | (row_ss[1:] != row_ss[:-1])
            rfirst = np.nonzero(newr)[0]
            rcnt = np.diff(np.concatenate([rfirst, [nnz]]))
            e0 = ro[rfirst]
            run_start = pos_s[ro[rfirst]]
            run_end = pos_s[ro[rfirst + rcnt - 1]]
            assert (run_end - run_start + 1 == rcnt).all(), \
                "row run not contiguous in the accumulator"
            rcq = rk_s[rfirst] // S
            sb = rk_s[rfirst] % S
            oc = ocs[rc_order[np.searchsorted(rc_sorted, rcq)]]
            vlo = (row_s[e0] & 127).astype(np.int64)
            hi8 = ((row_s[e0] % region_rows) >> 7).astype(np.int8)
            c_hi[oc, sb, vlo] = hi8
            c_end[oc, sb, vlo] = run_end.astype(np.int8)
            c_beg[oc, sb, vlo] = (run_start - 1).astype(np.int8)

    # ---- A streams ----------------------------------------------------------
    ncap = nsteps * cb
    a_r = np.zeros((ncap, S, L), np.int8)
    a_vals = np.full((ncap, S, L), pad_val, np.float32)
    a_page = np.zeros(ncap, np.int32)
    cc_s = cc[eo]
    a_r[a_chunk_s, sub_s, a_lane] = (cc_s & 127).astype(np.int8)
    a_vals[a_chunk_s, sub_s, a_lane] = vv[eo]
    chunk_tile = np.zeros(ncap, np.int32)
    if nnz:
        np.maximum.at(chunk_tile, a_chunk_s, (cc_s >> 10).astype(np.int32))
    a_page[:] = chunk_tile
    a_sub = np.zeros((ncap, S, L), np.int8)
    a_sub[a_chunk_s, sub_s, cc_s & 127] = ((cc_s >> 7) & 7).astype(np.int8)
    el_slot = np.empty(nnz, np.int64)
    el_slot[order[eo]] = a_chunk_s * CHUNK + sub_s * L + a_lane

    return PlanarSpMVLayout(
        a_r=a_r, xperm=np.zeros((0, S, S, L), np.int8), a_vals=a_vals,
        a_page=a_page, rg=rg, planes=np.zeros((nsteps, 0, S, L), np.int8),
        c_code=c_code, c_hi=c_hi, c_lo=np.zeros((0, S, L), np.int8),
        num_rows=nrows, num_cols=ncols, nnz=nnz,
        num_col_tiles=ntiles, num_regions=nregions,
        region_rows=region_rows, cb=cb, rstep=rstep, f=f, dmax=0,
        nsteps=nsteps, dstep=dstep, num_slots=num_slots,
        fill_a=nnz / max(nca * CHUNK, 1),
        fill_stream=nnz / max(nsteps * f * CHUNK, 1),
        el_slot=el_slot, el_stream=None, a_sub=a_sub,
        triples=triples, c_end=c_end, c_beg=c_beg,
    )


def permc_stream_rows(lay, block: int = 4096) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """A PERM-C layout's phase-C streams re-keyed by stream position:
    int8 (hi, lo) planes of shape (nsteps*f, 8, 128), as a "free" layout's
    c_hi/c_lo. Where lane v of sublane s of flushed chunk q holds a run,
    positions c_beg+1 .. c_end of that sublane get lo = v and
    hi = c_hi[q, s, v]; every other position gets 0, so its (zero) stream
    element adds nothing at row 0 of its region. Works through `block`
    chunks at a time."""
    nchunks = len(lay.c_code)
    hi = np.zeros((nchunks, S, L), np.int8)
    lo = np.zeros((nchunks, S, L), np.int8)
    for q0 in range(0, nchunks, block):
        end = lay.c_end[q0:q0 + block].astype(np.int64)
        beg = lay.c_beg[q0:q0 + block].astype(np.int64)
        q, s, v = np.nonzero(end > beg)
        n = end[q, s, v] - beg[q, s, v]
        first = np.repeat(beg[q, s, v] + 1, n)
        pos = first + np.arange(len(first)) - np.repeat(np.cumsum(n) - n, n)
        at = ((np.repeat(q, n) + q0) * S + np.repeat(s, n)) * L + pos
        lo.reshape(-1)[at] = np.repeat(v, n).astype(np.int8)
        hi.reshape(-1)[at] = np.repeat(lay.c_hi[q + q0, s, v], n)
    return hi, lo
