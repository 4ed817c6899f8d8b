"""Planar-deposit router layout (numpy, host side).

The port's copy of the numpy path of `graphlily_tpu/io/planar_format.py`:
for every input it builds the same arrays bit for bit (the tests hold the
two equal), so either package's layout drives the port's `PlanarSpMV`.
`deal="permc"` packs through io/permc_format.pack_permc, as in the JAX
package. The JAX package's native C++ planar packer is not copied
(ROADMAP queue 1, item 5a). The tropical packer
(io/tropical_format.py) packs with `hi_pad=-1` and `pad_val=FLOAT_INF`.
`planes_to_triples` works through the steps in blocks, so it stays within
a few hundred MB on the full pokec stand-in, where one pass would allocate
several GB.

What the layout means (S = 8 sublanes, L = 128 lanes, CHUNK = S * L):
  * A-chunk c holds up to 1024 nnz of one 1024-column tile a_page[c].
    Element (c, s, l) has the value a_vals[c, s, l] and the column
      deal "free":   a_page[c]*1024 + a_sub[c, s, a_r[c,s,l]]*128 + a_r[c,s,l]
                     (a_sub is indexed by the SOURCE lane a_r[c,s,l]);
      deal "bucket": column-tile x re-laid by the xperm planes,
                     x2[t, d, l] = x[t*1024 + s*128 + (v & 127)] where
                     xperm[t, s, d, l] = v < 0 (0 where no plane takes),
                     and the element reads x2[a_page[c], s, a_r[c,s,l]].
  * rg[t, j] = (w1, w2) for step t. Slots [0, dstep) are deposit pieces,
    slots [dstep, rstep) flushes; w2 == 0 is an inactive slot.
    deposit (w2 > 0): k = w1 & 0xFF (A-chunk t*cb + k), p = w1 >> 8 (its
      plane, equal to j), slot = w2 & 0xFFF. Where planes[t, p, s, l] = v
      < 0, accumulator `slot` element (s, l) takes element (s, v & 127)
      of the chunk's gathered products. The taken lanes of one (piece,
      sublane) are one contiguous run [d0, d0 + n) fed from source lanes
      [a0, a0 + n): `planes_to_triples` packs it as a0 | d0<<7 | n<<14.
    flush (w2 < 0): slot = w2 & 0xFFF, q = (w2 >> 16) & 0xFF. It moves
      the whole slot to flush-stream chunk t*f + q and zeroes it (no
      cursor mask: unused elements are zero, with c_hi = c_lo = 0).
  * Flush-stream chunk s belongs to region c_code[s] (-1: none); its
    element p lands in row c_code[s]*region_rows + c_hi[s, p]*128
    + c_lo[s, p], as in the roll layout (io/router_format.py), so
    `deposit_targets` reads these descriptor words unchanged.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np

from .matrix import CSRMatrix
from .formatter import util_round_csr_matrix_dim
from .router_format import REGION_ROWS, CHUNK, MAX_REGIONS, _balance_chunks

S = 8
L = 128
DEALS = ("free", "bucket", "permc")


@dataclasses.dataclass
class PlanarSpMVLayout:
    """Static streams and schedules of the planar router (all numpy)."""

    a_r: np.ndarray        # (NSTEPS*CB, 8, 128) int8 : source lane of x
    xperm: np.ndarray      # (NTILES, 8, 8, 128) int8 : x re-layout planes
                           #   (deal "bucket"); (0, 8, 8, 128) for "free"
    a_vals: np.ndarray     # (NSTEPS*CB, 8, 128) f32  : values (pad 0)
    a_page: np.ndarray     # (NSTEPS*CB,) int32       : 1024-col tile id
    rg: np.ndarray         # (NSTEPS, RSTEP, 2) int32 : descriptor words
    planes: np.ndarray     # (NSTEPS, DMAX, 8, 128) int8 : deposit planes
    c_code: np.ndarray     # (NSTEPS*F,) int32 : region per flush (-1 skip)
    c_hi: np.ndarray       # (NSTEPS*F, 8, 128) int8
    c_lo: np.ndarray       # (NSTEPS*F, 8, 128) int8
    num_rows: int
    num_cols: int
    nnz: int
    num_col_tiles: int
    num_regions: int
    region_rows: int
    cb: int
    rstep: int
    f: int
    dmax: int
    nsteps: int
    fill_a: float
    fill_stream: float
    dstep: int = 0         # deposit slots per step (rstep - f)
    num_slots: int = 0     # rotated accumulator slots
    el_slot: np.ndarray | None = None    # (nnz,) original nnz -> a_vals slot
    el_stream: np.ndarray | None = None  # (nnz,) original nnz -> flush-stream
                                         # slot (keep_el_stream=True only)
    a_sub: np.ndarray | None = None      # deals "free" and "permc":
                                         # (NSTEPS*CB, 8, 128) int8
                                         # source-sublane table
    triples: np.ndarray | None = None    # planes_to_triples(self), where
                                         # it replaced `planes` (the
                                         # tropical "triples" format, and
                                         # every PERM-C layout)
    c_end: np.ndarray | None = None      # PERM-C only: (NSTEPS*F, 8, 128)
                                         # int8 run end per DEST lane
    c_beg: np.ndarray | None = None      # PERM-C only: run start - 1

    @property
    def mem_bytes(self) -> int:
        return (self.a_r.nbytes + self.xperm.nbytes
                + self.a_vals.nbytes + self.a_page.nbytes
                + self.rg.nbytes + self.planes.nbytes + self.c_code.nbytes
                + self.c_hi.nbytes + self.c_lo.nbytes)


def planes_to_triples(lay, block_steps: int = 64) -> np.ndarray:
    """Losslessly compress a planar layout's deposit planes to triple-run
    words: every (piece, sublane) takes ONE contiguous accumulator run
    [d0, d0 + n) from ONE contiguous source run starting at a0, so the
    1 KB (8, 128) int8 plane becomes 8 int32 words a0 | d0<<7 | n<<14.
    Same result as the JAX package's `planes_to_triples`:
    (nsteps, ceil(dstep/128), 8, 128) int32, word of piece p of step t
    and sublane s at [t, p >> 7, s, p & 127]. Raises ValueError if a plane
    breaks the run invariant."""
    nsteps, dmax = lay.planes.shape[:2]
    tp = (lay.dstep + L - 1) // L
    if dmax > tp * L:
        raise ValueError(f"{dmax} planes per step exceed {tp * L} words")
    tw = np.zeros((nsteps, tp, S, L), np.int32)
    lane_i = np.arange(L)
    p = np.arange(dmax)
    for t0 in range(0, nsteps, block_steps):
        pv = lay.planes[t0:t0 + block_steps].astype(np.int32)
        take = pv < 0
        n_ = take.sum(axis=3)                     # (steps, dmax, 8)
        d0 = np.where(n_ > 0, np.argmax(take, axis=3), 0)
        src = pv & 127
        a0 = np.take_along_axis(src, d0[..., None], axis=3)[..., 0]
        a0 = np.where(n_ > 0, a0, 0)
        run = ((lane_i >= d0[..., None]) & (lane_i < (d0 + n_)[..., None]))
        if not (take == run).all():
            raise ValueError("plane take-mask is not a single run")
        expect = (a0[..., None] + lane_i - d0[..., None]) & 127
        if not (np.where(run, src, 0) == np.where(run, expect, 0)).all():
            raise ValueError("plane source lanes are not contiguous")
        words = (a0 | (d0 << 7) | (n_ << 14)).astype(np.int32)
        # two advanced indices around a slice: dims are (dmax, steps, 8)
        tw[t0:t0 + block_steps][:, p >> 7, :, p & 127] = \
            words.transpose(1, 0, 2)
    return tw


def simulate_cursors(dc, dr, dl, nkeys: int):
    """Per-(key, sublane) cursor simulation: deposits run in (dc, dr)
    order; one that would overflow any sublane past 128 lanes is SPLIT at
    the boundary (piece 1 tops the accumulator, a flush drains it, piece
    2 restarts at lane 0). `dr` doubles as the cursor key (< nkeys)."""
    ed = np.lexsort((dr, dc))
    dc, dr, dl = dc[ed], dr[ed], dl[ed]
    nd_ = len(dc)
    C = np.zeros((nkeys, S), np.int64)
    cycle = np.zeros(nkeys, np.int64)
    d_dest1 = np.zeros((nd_, S), np.int64)
    d_part1 = np.zeros((nd_, S), np.int64)
    d_cyc1 = np.zeros(nd_, np.int64)
    d_cyc2 = np.zeros(nd_, np.int64)
    d_split = np.zeros(nd_, bool)
    for i in range(nd_):
        r = dr[i]
        lens = dl[i]
        Cr = C[r]
        if np.any(Cr + lens > L):
            p1 = np.minimum(lens, L - Cr)
            d_dest1[i] = Cr
            d_part1[i] = p1
            d_cyc1[i] = cycle[r]
            d_split[i] = True
            cycle[r] += 1
            C[r] = lens - p1
            d_cyc2[i] = cycle[r]
        else:
            d_dest1[i] = Cr
            d_part1[i] = lens
            d_cyc1[i] = d_cyc2[i] = cycle[r]
            C[r] = Cr + lens
    return types.SimpleNamespace(
        ed=ed, dc=dc, dr=dr, dl=dl, dest1=d_dest1, part1=d_part1,
        cyc1=d_cyc1, cyc2=d_cyc2, split=d_split, C=C, cycle=cycle)


def _largest_remainder_quotas(M):
    """Per (chunk, class): partition the 8 dest sublanes among the class's
    (<= 8) source columns by D'Hondt allocation: every active column gets
    1, then each remaining sublane goes to the column with the largest
    m/q. M is (nc, 128, 8) int counts; returns q (same shape, int64, sum
    over the last axis == 8 wherever the class is nonempty)."""
    act = M > 0
    q = act.astype(np.int64)
    navail = 8 - q.sum(axis=2)
    navail[q.sum(axis=2) == 0] = 0
    for _ in range(7):
        take = navail > 0
        if not take.any():
            break
        score = np.where(act, M / np.maximum(q, 1), -1.0)
        pick = np.argmax(score, axis=2)
        np.put_along_axis(q, pick[:, :, None],
                          np.take_along_axis(q, pick[:, :, None], 2)
                          + take[:, :, None], 2)
        navail -= take
    return q


def _running_rank(keys: np.ndarray) -> np.ndarray:
    """Rank of each element among the earlier elements with its key, for
    keys already grouped (equal keys adjacent)."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int64)
    new = np.ones(n, bool)
    new[1:] = keys[1:] != keys[:-1]
    starts = np.nonzero(new)[0]
    return np.arange(n) - np.repeat(starts, np.diff(np.append(starts, n)))


def _deal_free(rr, cc, vv, order, nnz, ntiles, region_rows):
    """deal "free" front end: chained-gather chunk/sublane/lane assignment.

    Elements sorted (tile, row, col); chunks are 1024-element windows per
    tile. Dest sublanes are dealt by class quotas (class = col & 127,
    `_largest_remainder_quotas`) rotated per (class, chunk), so a hub
    column's elements spread over all 8 sublanes. The quota sets
    partition the sublanes per (chunk, class), so each (chunk, dest
    sublane, class) has one source sublane: the a_sub table, indexed by
    the source lane, is well defined. A sublane past 128 elements spills
    its row tail to another round of chunks of the same tile.

    Returns (rr, cc, vv, order, a_chunk, dest_sub, lane, chunk_tile, nca)
    with elements re-sorted to (chunk, dest sublane, row) order."""
    tile = cc >> 10
    sig = (cc >> 7) & 7
    rho = cc & 127
    tcount = np.bincount(tile, minlength=ntiles)
    cpt0 = (tcount + CHUNK - 1) // CHUNK
    chunk_of = np.zeros(nnz, np.int64)
    sub_of = np.zeros(nnz, np.int64)
    chunk_round = np.zeros(nnz, np.int64)
    rounds = []                      # chunks per tile, per round
    pend = np.arange(nnz)            # elements to deal this round
    local_chunk = (np.arange(nnz)
                   - np.repeat(np.concatenate([[0], np.cumsum(tcount)[:-1]]),
                               tcount)) // CHUNK if nnz else np.zeros(0,
                                                                      np.int64)
    round_no = 0
    while len(pend):
        assert round_no < 16, "free-deal spill recursion exceeded 16 rounds"
        if round_no == 0:
            rc = local_chunk[pend]
            rcpt = cpt0
        else:
            # spilled elements re-dealt into fresh rank-window chunks of
            # their tile (pend stays tile-then-row ordered)
            tcnt = np.bincount(tile[pend], minlength=ntiles)
            rcpt = (tcnt + CHUNK - 1) // CHUNK
            tstart = np.concatenate([[0], np.cumsum(tcnt)[:-1]])
            rc = (np.arange(len(pend)) - tstart[tile[pend]]) // CHUNK
        rbase = np.concatenate([[0], np.cumsum(rcpt)])
        ch = rbase[tile[pend]] + rc
        ncr = max(int(rbase[-1]), 1)
        key = (ch * L + rho[pend]) * 8 + sig[pend]
        M = np.bincount(key, minlength=ncr * L * 8).reshape(ncr, L, 8)
        q = _largest_remainder_quotas(M)
        cum = np.cumsum(q, axis=2) - q          # exclusive per class
        # element sequence number within (chunk, class, col), row order
        ord2 = np.argsort(key, kind="stable")
        kk = np.empty(len(pend), np.int64)
        kk[ord2] = _running_rank(key[ord2])
        qe = q[ch, rho[pend], sig[pend]]
        start = (5 * rho[pend] + 3 * ch) % 8
        s = (start + cum[ch, rho[pend], sig[pend]] + kk % np.maximum(qe, 1)
             ) % 8
        # sublane capacity: the row tail past 128 lanes spills
        ord3 = np.argsort(ch * 8 + s, kind="stable")
        lane_r = np.empty(len(pend), np.int64)
        lane_r[ord3] = _running_rank((ch * 8 + s)[ord3])
        keep = lane_r < L
        chunk_of[pend[keep]] = ch[keep]    # round-local; renumbered below
        sub_of[pend[keep]] = s[keep]
        chunk_round[pend[keep]] = round_no
        rounds.append(rcpt)
        pend = pend[~keep]
        round_no += 1
    # global chunk numbering: per tile, round-0 chunks then spill chunks
    cpt_all = (np.stack(rounds, axis=0) if rounds
               else np.zeros((1, ntiles), np.int64))
    cpt_final = cpt_all.sum(axis=0)
    tile_base = np.concatenate([[0], np.cumsum(cpt_final)])
    roff = np.cumsum(cpt_all, axis=0) - cpt_all   # (rounds, ntiles)
    a_chunk = np.zeros(nnz, np.int64)
    for rno, rcpt in enumerate(rounds):
        m = chunk_round == rno
        if not m.any():
            continue
        rb0 = np.concatenate([[0], np.cumsum(rcpt)])
        loc = chunk_of[m] - rb0[tile[m]]
        a_chunk[m] = tile_base[tile[m]] + roff[rno, tile[m]] + loc
    nca = max(int(tile_base[-1]), 1)
    chunk_tile = np.repeat(np.arange(ntiles), cpt_final).astype(np.int32)
    # final element order: (chunk, dest sublane, row) -> lanes 0..count-1
    ordf = np.lexsort((rr, sub_of, a_chunk))
    rr, cc, vv = rr[ordf], cc[ordf], vv[ordf]
    order = order[ordf]
    a_chunk, dest_sub = a_chunk[ordf], sub_of[ordf]
    lane = _running_rank(a_chunk * 8 + dest_sub)
    assert not nnz or lane.max() < L
    return rr, cc, vv, order, a_chunk, dest_sub, lane, chunk_tile, nca


def choose_planar_region_rows(nrows: int, ncols: int, nnz: int) -> int:
    """Region height: deposits scale as ntiles*nrows/R, the reduce work
    with R; the sqrt optimum rounded to a multiple of 128 and clamped to
    [1024, 8192] and the MAX_REGIONS cap (the JAX package's rule, so both
    build the same layout)."""
    ntiles = max(ncols // 1024, 1)
    r_opt = (ntiles * nrows * 2.0e8 / max(nnz, 1)) ** 0.5
    r = int(round(r_opt / 128)) * 128
    r_min = ((nrows + MAX_REGIONS - 1) // MAX_REGIONS + 127) // 128 * 128
    return max(min(max(r, 1024), 8192), r_min)


def pack_planar(csr: CSRMatrix, config=None, cb: int | None = None,
                region_rows: int | None = None,
                keep_el_stream: bool = False,
                deal: str = "bucket", hi_pad: int = 0,
                pad_val: float = 0.0) -> PlanarSpMVLayout:
    """Build the planar layout and schedules (the JAX package's numpy
    path). `pad_val` fills empty A-value slots (the (x) annihilator: 0 for
    MULADD/ANDOR, FLOAT_INF for the tropical engine), `hi_pad` unoccupied
    c_hi slots (0 for the reduce; -1 marks them for the tropical split
    builder). `deal`: "bucket" (sublane = the column's bucket after a
    per-tile degree-sorted snake re-layout of the columns, read through
    the xperm planes), "free" (dest sublanes quota-dealt per class,
    chained gather through a_sub, no xperm) or "permc"
    (io/permc_format.pack_permc; with `keep_el_stream` or a nonzero
    `hi_pad`, which only the tropical pass 1 asks for, it packs "free",
    as the JAX package does). `keep_el_stream` records each nnz's
    flush-stream position. `config` is accepted for call-site parity and
    unused."""
    del config
    if deal not in DEALS:
        raise ValueError(f"unknown planar deal {deal!r}; the port packs "
                         f"{DEALS}")
    if deal == "permc":
        if keep_el_stream or hi_pad != 0:
            deal = "free"
        else:
            from .permc_format import pack_permc
            return pack_permc(csr, pad_val=pad_val, cb=cb,
                              region_rows=region_rows)
    work = csr.copy()
    util_round_csr_matrix_dim(work, 1024, 1024)
    nrows, ncols = work.num_rows, work.num_cols
    if region_rows is None:
        region_rows = choose_planar_region_rows(nrows, ncols, work.nnz)
    assert region_rows % 128 == 0 and 128 <= region_rows <= REGION_ROWS
    nregions = (nrows + region_rows - 1) // region_rows
    if nregions > MAX_REGIONS:
        raise ValueError(
            f"{nrows} rows -> {nregions} regions exceeds the planar router "
            f"limit {MAX_REGIONS}")
    nnz = work.nnz
    rr = work.row_ids().astype(np.int64)
    cc = work.adj_indices[:nnz].astype(np.int64)
    vv = work.adj_data[:nnz].astype(np.float32)
    ntiles_pad = ncols // 1024
    if deal == "free":
        order0 = np.lexsort((cc, rr, cc >> 10))
        (rr, cc, vv, order, a_chunk, bucket, lane, chunk_tile,
         nca) = _deal_free(rr[order0], cc[order0], vv[order0], order0,
                           nnz, ntiles_pad, region_rows)
        xperm = np.zeros((0, S, S, L), np.int8)
        return _pack_planar_tail(
            rr, cc, vv, order, a_chunk, bucket, lane, chunk_tile, nca,
            xperm, (cc & 127).astype(np.int8), nrows, ncols, nnz,
            region_rows, nregions, cb, keep_el_stream, hi_pad, pad_val,
            with_sub=True)
    tile = cc >> 10

    # ---- per-tile column re-layout: balance bucket loads -------------------
    # Columns are reassigned to (sublane, lane) slots within their tile by
    # a degree-sorted snake deal over the 8 sublanes; the xperm planes
    # materialize x in that layout at run time.
    deg = np.bincount(cc, minlength=ncols)
    col_mat = np.arange(ncols).reshape(ntiles_pad, 1024)
    dorder = np.argsort(-deg.reshape(ntiles_pad, 1024), axis=1,
                        kind="stable")
    pos = np.empty((ntiles_pad, 1024), np.int64)
    np.put_along_axis(pos, dorder, np.arange(1024)[None, :], axis=1)
    rnd, idx8 = pos // 8, pos % 8
    col_sub = np.where(rnd % 2 == 0, idx8, 7 - idx8).reshape(-1)
    col_lane = rnd.reshape(-1)
    bucket = col_sub[cc]

    # x-shuffle planes: (tile, source sublane) -> dest plane (8, 128),
    # entry v < 0 takes source lane v & 127
    xperm = np.zeros((ntiles_pad, S, S, L), np.int8)
    xperm[col_mat // 1024, (col_mat % 1024) >> 7,
          col_sub.reshape(ntiles_pad, 1024),
          col_lane.reshape(ntiles_pad, 1024)] = (
        col_mat % 128 - 128).astype(np.int8)
    if nrows < (1 << 22) and ncols < (1 << 19):
        key = ((tile.astype(np.uint64) << 47)
               | (bucket.astype(np.uint64) << 44)
               | (rr.astype(np.uint64) << 22) | cc.astype(np.uint64))
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((cc, rr, bucket, tile))
    rr, cc, vv = rr[order], cc[order], vv[order]
    tile, bucket = tile[order], bucket[order]

    # ---- chunk/lane assignment: rank within (tile, bucket) -----------------
    grp = (tile << 3) | bucket
    rank = _running_rank(grp)
    lane = rank % L
    cit = rank // L                          # chunk-in-tile (per bucket)
    cpt = np.zeros(ntiles_pad, np.int64)     # max over buckets of ceil(n/128)
    if nnz:
        gstart = np.nonzero(rank == 0)[0]
        gcount = np.diff(np.append(gstart, nnz))
        np.maximum.at(cpt, grp[gstart] >> 3, (gcount + L - 1) // L)
    tile_base = np.concatenate([[0], np.cumsum(cpt)])
    nca = max(int(tile_base[-1]), 1)
    a_chunk = tile_base[tile] + cit
    chunk_tile = (np.repeat(np.arange(ntiles_pad), cpt).astype(np.int32)
                  if nca > 1 or cpt.sum() else np.zeros(nca, np.int32))
    return _pack_planar_tail(
        rr, cc, vv, order, a_chunk, bucket, lane, chunk_tile, nca,
        xperm, col_lane[cc].astype(np.int8), nrows, ncols, nnz,
        region_rows, nregions, cb, keep_el_stream, hi_pad, pad_val,
        with_sub=False)


def _pack_planar_tail(rr, cc, vv, order, a_chunk, bucket, lane, chunk_tile,
                      nca, xperm, a_r_val, nrows, ncols, nnz, region_rows,
                      nregions, cb, keep_el_stream, hi_pad, pad_val,
                      with_sub):
    """Shared back half of pack_planar: subruns -> deposits -> cursor
    simulation -> step balancing -> descriptor, plane and reduce-side
    streams. `bucket` is the element's dest sublane, `a_r_val` its
    phase-A lane; `with_sub` also emits the chained-gather a_sub table."""
    # ---- subruns: contiguous (chunk, sublane, region) ranges --------------
    region = rr // region_rows
    if nnz:
        ns = np.ones(nnz, bool)
        ns[1:] = ((a_chunk[1:] != a_chunk[:-1])
                  | (bucket[1:] != bucket[:-1])
                  | (region[1:] != region[:-1]))
        s_start = np.nonzero(ns)[0]
    else:
        s_start = np.zeros(0, np.int64)
    s_len = np.diff(np.append(s_start, nnz))
    s_chunk = a_chunk[s_start]
    s_sub = bucket[s_start]
    s_region = region[s_start]
    s_lane0 = lane[s_start]
    nsub = len(s_start)

    # ---- deposits: one per (chunk, region) --------------------------------
    dk = s_chunk * np.int64(nregions) + s_region
    d_order = np.argsort(dk, kind="stable")      # subruns grouped by deposit
    dk_s = dk[d_order]
    ndg = np.ones(nsub, bool)
    if nsub:
        ndg[1:] = dk_s[1:] != dk_s[:-1]
    d_first = np.nonzero(ndg)[0]
    nd = len(d_first)
    d_chunk = dk_s[d_first] // nregions
    d_region = dk_s[d_first] % nregions
    sub_of_dep = np.repeat(np.arange(nd), np.diff(np.append(d_first, nsub)))
    d_lens = np.zeros((nd, S), np.int64)         # per-deposit sublane lengths
    if nsub:
        d_lens[sub_of_dep, s_sub[d_order]] = s_len[d_order]

    def _simulate(dc, dr, dl):
        return simulate_cursors(dc, dr, dl, nregions)

    # ---- balance chunks across steps by exact item weight -----------------
    # Flushes land in their triggering deposit's step, so rstep and f are
    # set by the worst step: pass 1 balances on a heuristic, simulates,
    # and feeds the exact per-chunk item counts into a second LPT pass.
    if cb is None:
        dpc = nd / max(nca, 1) + 2.0
        cb = int(min(32, max(8, 256 // dpc)))
    nsteps_dep = (nca + cb - 1) // cb
    d_chunk0 = d_chunk                           # pre-balance chunk ids
    if nsteps_dep > 1:
        weight = np.zeros(nca, np.int64)
        np.add.at(weight, d_chunk0, 1)
        weight += np.bincount(a_chunk, minlength=nca) // 512 + 1
        new1 = _balance_chunks(weight, nsteps_dep, cb)
        sim1 = _simulate(new1[d_chunk0], d_region, d_lens)
        items = np.ones(nca, np.int64)
        np.add.at(items, d_chunk0[sim1.ed], np.where(sim1.split, 3, 1))
        new_of_old = _balance_chunks(items, nsteps_dep, cb)
        ct = np.zeros(nsteps_dep * cb, np.int32)
        ct[new_of_old[:len(chunk_tile)]] = chunk_tile
        chunk_tile = ct
        a_chunk = new_of_old[a_chunk]
        d_chunk = new_of_old[d_chunk0]
    elif len(chunk_tile) < nsteps_dep * cb:
        chunk_tile = np.concatenate(
            [chunk_tile,
             np.zeros(nsteps_dep * cb - len(chunk_tile), np.int32)])

    # deposits execute in (chunk, region) order
    sim = _simulate(d_chunk, d_region, d_lens)
    ed = sim.ed
    d_chunk, d_region = sim.dc, sim.dr
    d_dest1, d_part1 = sim.dest1, sim.part1
    d_cyc1, d_cyc2, d_split = sim.cyc1, sim.cyc2, sim.split
    C, cycle = sim.C, sim.cycle
    inv_ed = np.empty(nd, np.int64)
    inv_ed[ed] = np.arange(nd)
    d_step = d_chunk // cb
    drain_regions = np.nonzero(C.any(axis=1))[0]

    # region-chunk (rc) ids: (region, cycle) -> linear
    ncyc = cycle + C.any(axis=1)
    rc_base = np.concatenate([[0], np.cumsum(ncyc)])
    nrc = int(rc_base[-1])

    # ---- descriptor stream: per step all deposit pieces, then flushes -----
    n_drain = len(drain_regions)
    drain_per_step = cb + 2
    n_drain_steps = (n_drain + drain_per_step - 1) // drain_per_step
    nsteps = nsteps_dep + n_drain_steps

    # K-rotated slots: a region's cycles rotate through K slots, K > the
    # distinct cycles one step's deposits touch, so a step's flushes never
    # race its own later-cycle deposits
    if nd:
        cyc_span = int(d_cyc2.max()) + 2
        pc_reg = np.concatenate([d_region, d_region[d_split]])
        pc_step = np.concatenate([d_step, d_step[d_split]])
        pc_cyc = np.concatenate([d_cyc1, d_cyc2[d_split]])
        key = ((pc_reg * np.int64(nsteps_dep + 1) + pc_step) * cyc_span
               + pc_cyc)
        urs = np.unique(key) // cyc_span
        uk2, cnt = np.unique(urs, return_counts=True)
        kmax = np.ones(nregions, np.int64)
        np.maximum.at(kmax, uk2 // np.int64(nsteps_dep + 1), cnt)
        K = kmax + 1
    else:
        K = np.full(nregions, 2, np.int64)
    slot_base = np.concatenate([[0], np.cumsum(K)])
    num_slots = int(slot_base[-1])
    assert num_slots <= 4096, \
        f"rotated accumulator slots exceed the 12-bit field ({num_slots})"

    # deposit pieces in exec order: piece 1 of every deposit, the split
    # tail (piece 2) right after it
    per_dep = np.where(d_split, 2, 1)
    dbase = np.concatenate([[0], np.cumsum(per_dep)[:-1]]) if nd else \
        np.zeros(0, np.int64)
    npc = int(per_dep.sum())
    pc_step2 = np.zeros(npc, np.int64)
    pc_w1 = np.zeros(npc, np.int64)
    pc_slot = np.zeros(npc, np.int64)
    pc_piece = np.zeros(npc, np.int64)          # 2*dep + piece
    sp = np.nonzero(d_split)[0]
    if nd:
        pc_step2[dbase] = d_step
        pc_w1[dbase] = d_chunk % cb
        pc_slot[dbase] = slot_base[d_region] + d_cyc1 % K[d_region]
        pc_piece[dbase] = 2 * np.arange(nd)
        pc_step2[dbase[sp] + 1] = d_step[sp]
        pc_w1[dbase[sp] + 1] = d_chunk[sp] % cb
        pc_slot[dbase[sp] + 1] = (slot_base[d_region[sp]]
                                  + d_cyc2[sp] % K[d_region[sp]])
        pc_piece[dbase[sp] + 1] = 2 * sp + 1
    dep_counts = np.bincount(pc_step2, minlength=nsteps)
    dstep = max(int(dep_counts.max()) if npc else 0, 1)
    dep_first_of = np.concatenate([[0], np.cumsum(dep_counts)[:-1]])
    p_of = np.arange(npc) - dep_first_of[pc_step2]
    dmax = dstep
    pc_w1 = pc_w1 | (p_of << 8)

    # flushes: split flushes in their deposit's step (exec order, so
    # step-sorted), then the drains in trailing steps
    fl_step = np.concatenate([
        d_step[sp],
        nsteps_dep + np.arange(n_drain) // drain_per_step]).astype(np.int64)
    fl_rc = np.concatenate([
        rc_base[d_region[sp]] + d_cyc1[sp],
        rc_base[drain_regions] + cycle[drain_regions]])
    fl_slot = np.concatenate([
        slot_base[d_region[sp]] + d_cyc1[sp] % K[d_region[sp]],
        slot_base[drain_regions] + cycle[drain_regions] % K[drain_regions]])
    nf = len(fl_step)
    fl_counts = np.bincount(fl_step, minlength=nsteps)
    f = max(int(fl_counts.max()) if nf else 0, 1)
    assert f <= 256, f"flush ordinal overflow ({f})"
    fl_first = np.concatenate([[0], np.cumsum(fl_counts)[:-1]])
    q_of = np.arange(nf) - fl_first[fl_step]

    rstep = dstep + f
    rg = np.zeros((nsteps, rstep, 2), np.int32)
    if npc:
        rg[pc_step2, p_of, 0] = pc_w1.astype(np.int32)
        rg[pc_step2, p_of, 1] = (pc_slot | (1 << 15)).astype(np.int32)
    if nf:
        rg[fl_step, dstep + q_of, 1] = (
            fl_slot | (q_of << 16) | (np.int64(1) << 31)).astype(np.int32)

    # rc -> flush stream position
    c_code = np.full(nsteps * f, -1, np.int32)
    rc_linear = np.zeros(nrc + 1, np.int64)
    if nf:
        rc_linear[fl_rc] = fl_step * f + q_of
        c_code[rc_linear[fl_rc]] = np.searchsorted(
            rc_base, fl_rc, side="right") - 1

    # ---- deposit planes + reduce-side streams ------------------------------
    planes = np.zeros((nsteps, dmax, S, L), np.int8)
    c_hi = np.full((nsteps * f, S, L), hi_pad, np.int8)
    c_lo = np.zeros((nsteps * f, S, L), np.int8)
    el_stream_orig = None
    if nsub:
        piece_step = np.empty(2 * nd, np.int64)
        piece_slot = np.empty(2 * nd, np.int64)
        piece_step[pc_piece] = pc_step2
        piece_slot[pc_piece] = p_of

        sr_dep = inv_ed[sub_of_dep]              # exec-order deposit ids
        sr_sub = s_sub[d_order]
        sr_len = s_len[d_order]
        sr_lane0 = s_lane0[d_order]
        sr_p1 = np.minimum(d_part1[sr_dep, sr_sub], sr_len)
        sr_dest1 = d_dest1[sr_dep, sr_sub]

        def scatter_planes(lens, src0, dest0, piece_ids):
            keep = lens > 0
            ln, s0, dd = lens[keep], src0[keep], dest0[keep]
            st = piece_step[piece_ids[keep]]
            sl = piece_slot[piece_ids[keep]]
            sb = sr_sub[keep]
            off = _run_offsets(ln)
            flat = (np.repeat(st, ln) * (dmax * S * L)
                    + (np.repeat(sl, ln) * S + np.repeat(sb, ln)) * L
                    + np.repeat(dd, ln) + off)
            planes.reshape(-1)[flat] = (
                (np.repeat(s0, ln) + off) - 128).astype(np.int8)

        scatter_planes(sr_p1, sr_lane0, sr_dest1, 2 * sr_dep)
        scatter_planes(sr_len - sr_p1, sr_lane0 + sr_p1,
                       np.zeros(nsub, np.int64), 2 * sr_dep + 1)

        # element stream positions (piece-aware)
        off = _run_offsets(sr_len)
        in1 = off < np.repeat(sr_p1, sr_len)
        pos = np.where(in1, np.repeat(sr_dest1, sr_len) + off,
                       off - np.repeat(sr_p1, sr_len))
        cyc = np.where(in1, np.repeat(d_cyc1[sr_dep], sr_len),
                       np.repeat(d_cyc2[sr_dep], sr_len))
        el_rc = np.repeat(rc_base[d_region[sr_dep]], sr_len) + cyc
        el_stream = (rc_linear[el_rc] * CHUNK
                     + np.repeat(sr_sub, sr_len) * L + pos)
        el_src = np.repeat(s_start[d_order], sr_len) + off
        row_in_reg = rr[el_src] % region_rows
        oc, of_ = el_stream // CHUNK, el_stream % CHUNK
        c_hi[oc, of_ // L, of_ % L] = (row_in_reg >> 7).astype(np.int8)
        c_lo[oc, of_ // L, of_ % L] = (row_in_reg & 127).astype(np.int8)
        if keep_el_stream:
            el_stream_orig = np.empty(nnz, np.int64)
            el_stream_orig[order[el_src]] = el_stream

    # ---- A streams ----------------------------------------------------------
    ncap = nsteps * cb
    a_r = np.zeros((ncap, S, L), np.int8)
    a_vals = np.full((ncap, S, L), pad_val, np.float32)
    a_page = np.zeros(ncap, np.int32)
    a_r[a_chunk, bucket, lane] = a_r_val
    a_vals[a_chunk, bucket, lane] = vv
    a_page[:len(chunk_tile)] = chunk_tile
    a_sub = None
    if with_sub:
        # chained-gather sublane table, indexed by the SOURCE lane
        a_sub = np.zeros((ncap, S, L), np.int8)
        a_sub[a_chunk, bucket, cc & 127] = ((cc >> 7) & 7).astype(np.int8)
    el_slot = np.empty(nnz, np.int64)
    el_slot[order] = a_chunk * CHUNK + bucket * L + lane

    return PlanarSpMVLayout(
        a_r=a_r, xperm=xperm, a_vals=a_vals, a_page=a_page, rg=rg,
        planes=planes, c_code=c_code, c_hi=c_hi, c_lo=c_lo,
        num_rows=nrows, num_cols=ncols, nnz=nnz,
        num_col_tiles=ncols // 1024, num_regions=nregions,
        region_rows=region_rows, cb=cb, rstep=rstep, f=f, dmax=dmax,
        nsteps=nsteps, dstep=dstep, num_slots=num_slots,
        fill_a=nnz / max(nca * CHUNK, 1),
        fill_stream=nnz / max(nsteps * f * CHUNK, 1),
        el_slot=el_slot,
        el_stream=el_stream_orig if keep_el_stream and nnz else None,
        a_sub=a_sub,
    )


def _run_offsets(lens: np.ndarray) -> np.ndarray:
    """0..len-1 for each run, concatenated (empty for no runs)."""
    tot = int(lens.sum())
    return np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
