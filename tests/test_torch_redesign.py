"""The device forms that the chunked kernel (K6/K7, K7p), K4 fused (and
K4p fused), K1 (and K1p) and K8 read, derived at engine init from the
packed layouts, and their plain versions, on the CPU.

Chunked (`ops/chunked.chunk_entries`): every real entry of the layout
appears once and no padding slot does, for both pad values and both chunk
orders, which give the same form; the block table tiles the entries with
ranges inside one window group, and walking it as the kernel does covers
every entry once, in its own segment. Planar (`ops/planar.tile_columns`):
the int16 tile column equals the chained a_r -> a_sub gather of the plain
index. The plain versions over the derived forms equal the plain versions
over the layouts (bit for bit for ANDOR and ADDMIN, and for K4 fused in
every semiring: it adds through the flush stream), JAX `spmv_coo` on the
padded graph and the float64 oracle, with the tolerances of
test_torch_chunked.py and test_torch_planar.py.

Roll router (`ops/router.router_entries`): every element of every live
deposit appears once with its own value, column and row (against the
plain index), in deposit order or sorted by row within each region; the
blocks tile the elements and the kernel's walk covers each once in its
own segment. K1's plain walk of the form equals K2 -> K3's plain versions
(bit for bit for ANDOR, within 1e-4 * max|y64| for MULADD), JAX
`spmv_coo`, and, predicated, JAX `spmspv_coo`. Tropical
(`ops/tropical.split_pieces`): every plane entry v < 0 of every live piece
appears once, and the plain walk of the compact form equals the walk of
the deposit planes and the emulated Pallas split, for both deals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.io import matrix as jmatrix

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import (pack_csr_chunks, pack_planar, pack_permc,
                                    pack_router, pack_tropical,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.ops import (ChunkedSpMV, PlanarSpMV, RouterSpMV,
                                     TropicalSpMV)
from graphlily_tpu_torch.ops.chunked import chunk_entries, entry_slots
from graphlily_tpu_torch.ops.planar import tile_columns
from graphlily_tpu_torch.ops.router import router_entries
from graphlily_tpu_torch.ops.tropical import split_pieces

from test_torch_fixtures import (CHUNKED_FIXTURES, FIXTURES, PLANAR_FIXTURES,
                                 TROPICAL_FIXTURES, hub_window_csr)
from test_torch_io import to_jax
from test_torch_kernels import planes_walk
from test_torch_router import CPU, _references
from test_torch_tropical import _emulate_split
import test_torch_chunked
import test_torch_router

INF = float(tg.FLOAT_INF)
CHUNKED_CASES = {**CHUNKED_FIXTURES, "hub_window": hub_window_csr,
                 "hub_page": FIXTURES["hub_page"][0]}
PLANAR_CASES = {**PLANAR_FIXTURES,
                "hub_page": FIXTURES["hub_page"],
                "conflict": FIXTURES["conflict"]}
LAYOUTS = ["free", "bucket", "permc"]


# ---- chunked: the padding-free form ------------------------------------------
def _chunked(name, pad_val, order="row"):
    csr = CHUNKED_CASES[name]()
    return csr, pack_csr_chunks(csr, pad_val=pad_val, chunk_order=order)


@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("pad_val", [0.0, INF], ids=["zero", "inf"])
@pytest.mark.parametrize("name", ["rmat", "conflict", "hub_rows",
                                  "empty_windows", "hub_page"])
def test_chunk_entries_hold_every_real_entry_once(name, pad_val, order):
    """The form's entries are the layout's real slots (`el_slot`), each
    once, with their own lane, row and value; no padding slot appears."""
    csr, lay = _chunked(name, pad_val, order)
    slots = entry_slots(torch.from_numpy(lay.code),
                        torch.from_numpy(lay.el_slot)).numpy()
    assert len(slots) == csr.nnz == len(np.unique(slots))
    np.testing.assert_array_equal(np.sort(slots), np.sort(lay.el_slot))
    a = chunk_entries(lay, "cpu")
    np.testing.assert_array_equal(a.r.numpy(), lay.r.reshape(-1)[slots])
    np.testing.assert_array_equal(a.rows.numpy(), lay.rows.reshape(-1)[slots])
    np.testing.assert_array_equal(a.vals.numpy(), lay.vals.reshape(-1)[slots])
    pad = np.ones(lay.num_chunks * 1024, bool)
    pad[lay.el_slot] = False
    assert not np.isin(slots, np.flatnonzero(pad)).any()
    assert a.nbytes() < lay.r.nbytes + lay.rows.nbytes + lay.vals.nbytes


@pytest.mark.parametrize("pad_val", [0.0, INF], ids=["zero", "inf"])
@pytest.mark.parametrize("name", ["rmat", "hub_rows", "empty_windows",
                                  "hub_window"])
def test_chunk_entries_same_for_both_chunk_orders(name, pad_val):
    _, row = _chunked(name, pad_val, "row")
    _, col = _chunked(name, pad_val, "col")
    a, b = chunk_entries(row, "cpu"), chunk_entries(col, "cpu")
    for field in ("r", "rows", "vals", "seg_start", "seg_x", "seg_y",
                  "blocks"):
        np.testing.assert_array_equal(getattr(a, field).numpy(),
                                      getattr(b, field).numpy(), field)
    assert a.max_segments == b.max_segments


@pytest.mark.parametrize("block_entries", [64, 4096])
@pytest.mark.parametrize("name", ["rmat", "hub_rows", "empty_windows",
                                  "hub_window", "rect"])
def test_chunk_blocks_lie_in_one_window_group(name, block_entries):
    """Blocks tile the entries in order, each at most `block_entries`
    long and inside one window group (1024 rows); its segments [g0, g1)
    are exactly those meeting its range. The kernel's walk (8-entry
    vectors from e0 rounded down to 8, a segment found by binary search
    over the block's starts, the first clamped to e0, then walked
    forward) covers every entry once, each in its own segment, within the
    streams' storage, which is zeroed to a multiple of 8 entries."""
    _, lay = _chunked(name, 0.0, "col")
    a = chunk_entries(lay, "cpu", block_entries=block_entries)
    blocks = a.blocks.numpy().astype(np.int64)
    start = a.seg_start.numpy().astype(np.int64)
    group = a.seg_y.numpy().astype(np.int64) // 1024
    n = a.r.numel()
    assert blocks[0, 0] == 0 and blocks[-1, 1] == n
    np.testing.assert_array_equal(blocks[1:, 0], blocks[:-1, 1])
    assert ((blocks[:, 1] > blocks[:, 0])
            & (blocks[:, 1] - blocks[:, 0] <= block_entries)).all()
    assert a.max_segments == int((blocks[:, 3] - blocks[:, 2]).max())
    for t in (a.r, a.rows, a.vals):
        assert t.untyped_storage().nbytes() >= -(-n // 8) * 8 * t.itemsize
    hits = np.zeros(n, np.int64)
    for e0, e1, g0, g1 in blocks:
        assert start[g0] <= e0 < start[g0 + 1] and start[g1 - 1] < e1
        assert len(set(group[g0:g1])) == 1
        s_start = np.r_[e0, start[g0 + 1:g1]]
        for q in range(e0 & ~7, e1, 8):
            j = np.searchsorted(s_start, max(q, e0), side="right") - 1
            for e in range(max(q, e0), min(q + 8, e1)):
                while j + 1 < len(s_start) and s_start[j + 1] <= e:
                    j += 1
                assert start[g0 + j] <= e < start[g0 + j + 1]
                hits[e] += 1
    np.testing.assert_array_equal(hits, 1)
    # segments: one (chunk, sublane) each, offsets from the layout's code
    seg_slot = entry_slots(torch.from_numpy(lay.code),
                           torch.from_numpy(lay.el_slot)).numpy()[start[:-1]]
    code = lay.code.astype(np.int64)[seg_slot // 1024]
    nct = lay.num_col_tiles
    np.testing.assert_array_equal(
        a.seg_x.numpy(), (code % nct) * 1024 + (seg_slot // 128) % 8 * 128)
    np.testing.assert_array_equal(a.seg_y.numpy(), code // nct * 128)


def _padded_plain(lay, semiring, x):
    """The plain version over the layout's padded slots (the kernel's
    before the padding-free form): gather, product, scatter_reduce_."""
    nct = lay.num_col_tiles
    code = torch.from_numpy(lay.code).long().repeat_interleave(1024)
    sub = torch.arange(8).repeat_interleave(128).repeat(lay.num_chunks)
    window = code // nct
    col = (code - window * nct) * 1024 + sub * 128 + torch.from_numpy(
        lay.r).reshape(-1).long()
    row = window * 128 + torch.from_numpy(lay.rows).reshape(-1).long()
    g = semiring.mul(torch.from_numpy(lay.vals).reshape(-1), x[col])
    y = torch.full((lay.num_window_groups * 1024,), semiring.zero)
    reduce = "amin" if semiring.op == tg.OpType.ADDMIN else "sum"
    return y.scatter_reduce_(0, row, g, reduce, include_self=True)


@pytest.mark.parametrize("name", ["arithmetic", "logical", "tropical"])
@pytest.mark.parametrize("fixture", list(CHUNKED_CASES))
def test_chunked_plain_matches_padded_plain_and_references(fixture, name):
    """The plain version over the padding-free form equals the plain
    version over the padded slots (bit for bit for ANDOR and ADDMIN),
    and, clamped, JAX spmv_coo and the float64 oracle; K7p's plain
    version on a frontier of half the tiles equals the unpredicated one
    there."""
    semiring = tg.SEMIRINGS[name]
    csr, lay = _chunked(fixture, semiring.zero)
    eng = ChunkedSpMV(lay, semiring, CPU)
    x, mask = test_torch_chunked._vectors(lay, name)
    xt = torch.from_numpy(x)
    y, old = eng.spmv_plain(xt), _padded_plain(lay, semiring, xt)
    if name == "arithmetic":
        assert (y - old).abs().max() <= 1e-5 * old.abs().max()
    else:
        assert torch.equal(y.view(torch.int32), old.view(torch.int32))
    test_torch_chunked._assert_matches(
        eng(xt).numpy(), *_references(csr, name, x, mask,
                                      tg.MaskType.NO_MASK), name)
    act = (torch.from_numpy(np.random.default_rng(3).random(eng.nct))
           < 0.5).to(torch.uint8)
    xf = torch.where(act.bool().repeat_interleave(1024), xt,
                     torch.tensor(semiring.zero))
    yp = eng.spmv_predicated_plain(xf, act)
    assert torch.equal(yp.view(torch.int32),
                       eng.spmv_plain(xf).view(torch.int32))


# ---- K4 fused: pieces grouped by destination ------------------------------
def _planar(name, deal):
    build, region_rows = PLANAR_CASES[name]
    csr = build()
    if deal == "permc":
        return csr, pack_permc(csr, region_rows=region_rows)
    return csr, pack_planar(csr, region_rows=region_rows, deal=deal)


@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_tile_column_equals_the_chained_gather(name, deal):
    """page*1024 + a_col[src] of every deposited element is its column in
    the plain index: a_sub[c, s, r]*128 + r ("free", PERM-C) or s*128 + r
    into K5's x2 ("bucket"); the engine derives it at init."""
    _, lay = _planar(name, deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    a = eng.arrays
    np.testing.assert_array_equal(a.a_col.numpy(),
                                  tile_columns(a.a_r, a.a_sub).numpy())
    assert a.a_col.dtype == torch.int16 and a.a_col.shape == a.a_r.shape
    idx = eng.plain_index()
    col = idx["unit"] * 1024 + a.a_col.long()[idx["src"]]
    np.testing.assert_array_equal(col.numpy(), idx["col"].numpy())
    assert len(idx["src"]) == lay.nnz == len(np.unique(idx["src"]))


@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("fixture", list(PLANAR_CASES))
def test_fused_plain_matches_composed_plain_and_references(fixture, deal,
                                                           name):
    """K4 fused's plain version over its derived form equals K4 scatter ->
    K3's plain versions bit for bit (it adds in flush-stream order), and
    JAX spmv_coo and the float64 oracle; K4p fused's plain version at a
    frontier of half the tiles equals the composed one with the same
    activity."""
    csr, lay = _planar(fixture, deal)
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    x, mask = test_torch_router._vectors(lay)
    xt = torch.from_numpy(x)
    y = eng.fused_plain(xt)
    old = eng.reduce_plain(eng.scatter_plain(xt))
    assert torch.equal(y.view(torch.int32), old.view(torch.int32))
    test_torch_router._assert_matches(
        eng(xt), *_references(csr, name, x, mask, tg.MaskType.NO_MASK), name)
    act = (torch.from_numpy(np.random.default_rng(3).random(eng.num_act))
           < 0.5).to(torch.uint8)
    yp = eng.fused_plain(xt, None, act)
    old = eng.reduce_plain(eng.scatter_plain(xt, None, act))
    assert torch.equal(yp.view(torch.int32), old.view(torch.int32))
    assert eng.launches["fused"] == eng.launches["fused_pred"] == 0


# ---- K1: the roll router's elements in row or deposit order -----------------
ROUTER_ORDERS = ["deposit", "row"]
# (order, col_bits): K1p's form, K1's, and K1's cut to 1,024-column windows
ROUTER_FORMS = {"deposit": ("deposit", None), "row": ("row", None),
                "row_windows": ("row", 10)}


def _router(name, semiring=tg.ArithmeticSemiring, **entries_kw):
    build, region_rows = FIXTURES[name]
    csr = build()
    lay = pack_router(csr, region_rows=region_rows)
    eng = RouterSpMV(lay, semiring, CPU)
    if entries_kw:
        eng.use_entries(router_entries(eng, **entries_kw))
    return csr, lay, eng


@pytest.mark.parametrize("form", list(ROUTER_FORMS))
@pytest.mark.parametrize("name", list(FIXTURES))
def test_router_entries_hold_every_deposited_element_once(name, form):
    """The form's elements are the plain index's (every element of a live
    deposit, whose flush chunk has a region), each once, with its own
    value, column and row; deposit order keeps the plain index's order,
    row order sorts each (region, column window) by (row, column)."""
    order, col_bits = ROUTER_FORMS[form]
    _, lay, eng = _router(name, order=order, col_bits=col_bits)
    e = eng.entries
    idx = eng.plain_index()
    live = idx["row"][idx["dst"]] < eng.out_len
    src, col = idx["src"][live], idx["col"][live]
    row = idx["row"][idx["dst"]][live]
    assert e.vals.numel() == len(src) == lay.nnz
    got_col, got_row, flag = eng.entries_index()
    if order == "row":
        window = col >> e.col_bits
        region = row // eng.region_rows
        perm = torch.argsort(((region * (window.max() + 1) + window)
                              * eng.out_len + row) * eng.num_cols + col,
                             stable=True)
        src, col, row = src[perm], col[perm], row[perm]
        assert bool((flag == -1).all())
        key = region * (window.max() + 1) + window
        assert len(e.deps) == len(torch.unique(key))
    else:   # a roll chunk holds one page: its flag is each element's
        np.testing.assert_array_equal(flag.numpy(),
                                      idx["unit"][live].numpy())
        np.testing.assert_array_equal(flag.numpy(), col.numpy() // 128)
    np.testing.assert_array_equal(got_col.numpy(), col.numpy())
    np.testing.assert_array_equal(got_row.numpy(), row.numpy())
    np.testing.assert_array_equal(e.vals.numpy(), lay.a_vals.reshape(-1)[
        src.numpy()])
    assert e.vals.element_size() + e.idx.element_size() == 8   # per element
    for t in (e.vals, e.idx):
        assert t.untyped_storage().nbytes() >= -(-t.numel() // 8) * 8 * 4


@pytest.mark.parametrize("block_entries", [20, 100, 4096])
@pytest.mark.parametrize("form", list(ROUTER_FORMS))
@pytest.mark.parametrize("name", ["rmat", "multi_region", "hub_page",
                                  "region_1024"])
def test_router_blocks_cover_the_elements_once(name, form, block_entries):
    """Blocks tile the elements in order, at most `block_entries` long,
    each naming exactly the segments that meet it; the kernel's walk
    (8-element vectors from e0 rounded down to 8, a segment by binary
    search over the block's starts with the first clamped to e0, then a
    forward walk) covers every element once, in its own segment; a
    segment's elements lie in one page (a deposit) or column window (row
    order) and its record holds that offset and its region's."""
    order, col_bits = ROUTER_FORMS[form]
    _, lay, eng = _router(name, order=order, block_entries=block_entries,
                          col_bits=col_bits)
    e = eng.entries
    blocks = e.blocks.numpy().astype(np.int64)
    start = np.r_[e.deps[:, 0].numpy().astype(np.int64), e.vals.numel()]
    n = e.vals.numel()
    assert blocks[0, 0] == 0 and blocks[-1, 1] == n
    np.testing.assert_array_equal(blocks[1:, 0], blocks[:-1, 1])
    assert ((blocks[:, 1] > blocks[:, 0])
            & (blocks[:, 1] - blocks[:, 0] <= block_entries)).all()
    assert e.max_segments == int((blocks[:, 3] - blocks[:, 2]).max())
    hits = np.zeros(n, np.int64)
    for e0, e1, g0, g1 in blocks:
        assert start[g0] <= e0 < start[g0 + 1] and start[g1 - 1] < e1
        s_start = np.r_[e0, start[g0 + 1:g1]]
        for q in range(e0 & ~7, e1, 8):
            j = np.searchsorted(s_start, max(q, e0), side="right") - 1
            for k in range(max(q, e0), min(q + 8, e1)):
                while j + 1 < len(s_start) and s_start[j + 1] <= k:
                    j += 1
                assert start[g0 + j] <= k < start[g0 + j + 1]
                hits[k] += 1
    np.testing.assert_array_equal(hits, 1)
    col, row, _ = eng.entries_index()
    seg = np.repeat(np.arange(len(start) - 1), np.diff(start))
    deps = e.deps.numpy().astype(np.int64)
    region = row.numpy() // eng.region_rows
    np.testing.assert_array_equal(deps[seg, 2], region * eng.region_rows)
    width = 1024 if order == "deposit" else 2 ** e.col_bits
    np.testing.assert_array_equal(deps[seg, 1], col.numpy() // width * width)


@pytest.mark.parametrize("order", ROUTER_ORDERS)
@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_router_entries_plain_matches_fused_plain_and_references(fixture,
                                                                name, order):
    """K1's plain walk of its form equals K2 -> K3's plain versions (bit for
    bit for ANDOR, within 1e-4 * max|y64| for MULADD) and, clamped, JAX
    spmv_coo on the padded graph and the float64 oracle."""
    semiring = tg.SEMIRINGS[name]
    csr, lay, eng = _router(fixture, semiring, order=order)
    x, mask = test_torch_router._vectors(lay)
    xt = torch.from_numpy(x)
    y, old = eng.fused_entries_plain(xt), eng.fused_plain(xt)
    want, want64 = _references(csr, name, x, mask, tg.MaskType.NO_MASK)
    if name == "logical":
        assert torch.equal(y.view(torch.int32), old.view(torch.int32))
    else:
        assert (y - old).abs().max() <= 1e-4 * np.abs(want64).max()
    test_torch_router._assert_matches(eng(xt), want, want64, name)
    assert eng.launches["fused"] == 0


@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("fixture", ["uniform", "rmat", "multi_region",
                                     "hub_page", "region_4096"])
def test_router_entries_predicated_matches_spmspv_coo(fixture, name):
    """K1p's plain walk over the pages of a frontier (a third of the pages,
    values >= 0.5) equals K2p -> K3's plain versions, the unpredicated walk
    on the same x, and, clamped, JAX spmspv_coo on the padded graph."""
    semiring = tg.SEMIRINGS[name]
    csr, lay, eng = _router(fixture, semiring)
    rng = np.random.default_rng(5)
    on = rng.random(eng.num_act) < 0.34
    x = (rng.random(lay.num_cols).astype(np.float32) + 0.5) * np.repeat(
        on, 128)
    x[rng.random(lay.num_cols) < 0.5] = 0.0
    xt = torch.from_numpy(x)
    act = eng.activity(xt)
    y = eng.fused_entries_plain(xt, act)
    full, old = eng.fused_entries_plain(xt), eng.fused_plain(xt, None, act)
    if name == "logical":
        for ref in (full, old):
            assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    else:
        for ref in (full, old):
            assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, 1024, 1024)
    idx = np.flatnonzero(x)
    _, want = jops.spmspv_coo(
        jops.coo_from_csc(jmatrix.csr2csc(to_jax(padded))),
        jops.sparse_from_entries(idx, x[idx], capacity=len(x)),
        jg.SEMIRINGS[name])
    want = np.asarray(want)
    got = eng.call_predicated(xt).numpy()
    if name == "logical":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert eng.launches["fused_pred"] == 0


def test_router_engine_holds_both_forms():
    """K1 reads the row-ordered form and K1p the deposit-ordered one; the
    row form mixes pages in every segment, so K1p (which skips dead pages
    by deposit) refuses it."""
    _, lay, eng = _router("rmat", tg.LogicalSemiring)
    assert eng.entries.order == "row" and eng.pred_entries.order == "deposit"
    assert eng.entries.deps.shape[0] == lay.num_regions
    assert eng.init_seconds > 0
    with pytest.raises(ValueError, match="deposit"):
        eng.use_entries(router_entries(eng, "row"), pred=True)
    with pytest.raises(ValueError, match="order"):
        router_entries(eng, order="column")


# ---- K8: the split's compact form ------------------------------------------
TROPICAL_DEALS = ["free", "bucket"]


def _tropical(name, deal):
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    lay = pack_tropical(build(), tg.EngineConfig(planar_deal=deal),
                        region_rows=region_rows, kb=kb,
                        split_format="planes")
    return lay, TropicalSpMV(lay, tg.TropicalSemiring, CPU)


@pytest.mark.parametrize("deal", TROPICAL_DEALS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_split_pieces_hold_every_plane_entry_once(name, deal):
    """Each live piece's entry v < 0 at (s, l) appears once: the piece's
    sublane-s run covers l, and its lane byte is v & 127; the planes do not
    stay on the device."""
    lay, eng = _tropical(name, deal)
    p = eng.arrays.split
    assert not hasattr(eng.arrays, "planes2")
    t, j = np.nonzero(lay.rg2[:, :lay.dstep2, 1] > 0)
    w1 = lay.rg2[t, j, 0].astype(np.int64)
    planes = lay.planes2.reshape(lay.nsteps2, -1, 1024)[t, w1 >> 8]
    assert p.pieces.shape == (len(t), 4) and p.runs.shape == (len(t), 8)
    words = p.runs.numpy().astype(np.int64)
    d0, n = (words >> 7) & 127, (words >> 14) & 255
    first = p.pieces[:, 2].numpy().astype(np.int64)
    lanes = p.lanes.numpy().astype(np.int64)
    assert lanes.size == int((planes < 0).sum()) == n.sum()
    np.testing.assert_array_equal(first, np.r_[0, np.cumsum(n.sum(1))[:-1]])
    for i in range(len(t)):
        e = first[i]
        for s in range(8):
            row = planes[i, s * 128:(s + 1) * 128]
            taken = np.flatnonzero(row < 0)
            np.testing.assert_array_equal(taken, d0[i, s] + np.arange(n[i, s]))
            np.testing.assert_array_equal(lanes[e:e + n[i, s]],
                                          row[taken].astype(np.int64) & 127)
            e += n[i, s]
    target = eng.arrays.target2.numpy()
    np.testing.assert_array_equal(p.pieces[:, 1].numpy(), target[t, j])
    np.testing.assert_array_equal(
        p.pieces[:, 0].numpy(), lay.in_order[t * lay.kb + (w1 & 0xFF)])


@pytest.mark.parametrize("deal", TROPICAL_DEALS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_split_pieces_plain_matches_planes_walk_and_pallas(name, deal):
    """The plain walk of K8's compact form equals the walk of the deposit
    planes (the plain version before the form) and the emulated Pallas
    split, bit for bit, on a random g1 in which every value moves."""
    lay, eng = _tropical(name, deal)
    g1 = np.random.default_rng(3).integers(
        1, 2**31 - 1, eng.g1_numel).astype(np.int32)
    got = eng.split_plain(torch.from_numpy(g1)).numpy()
    np.testing.assert_array_equal(got, planes_walk(lay, g1))
    np.testing.assert_array_equal(got, _emulate_split(lay, g1))
    assert eng.launches["split"] == 0


def test_split_pieces_refuse_a_broken_run():
    """A piece whose sublane lanes are not one contiguous run raises."""
    lay, eng = _tropical("rmat", "free")
    a = eng.arrays
    planes = lay.planes2.copy()
    t, j = np.nonzero(lay.rg2[:, :lay.dstep2, 1] > 0)
    for ti, ji in zip(t, j):
        plane = planes[ti, int(lay.rg2[ti, ji, 0]) >> 8]
        taken = plane < 0
        near = taken | np.roll(taken, 1, 1) | np.roll(taken, -1, 1)
        s, lane = np.nonzero(taken.any(1)[:, None] & ~near)
        if len(s):
            plane[s[0], lane[0]] = -1      # a second run in that sublane
            break
    else:
        raise AssertionError("no sublane with room for a second run")
    with pytest.raises(ValueError, match="run"):
        split_pieces(a.rg2, torch.from_numpy(planes).reshape(-1),
                     a.in_order, a.target2, eng.kb, eng.dstep2)
