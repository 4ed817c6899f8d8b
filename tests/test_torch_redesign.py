"""The device forms that the chunked kernel (K6/K7, K7p) and K4 fused (and
K4p fused) read, derived at engine init from the packed layouts, and their
plain versions, on the CPU.

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
"""
import numpy as np
import pytest
import torch

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import pack_csr_chunks, pack_planar, pack_permc
from graphlily_tpu_torch.ops import ChunkedSpMV, PlanarSpMV
from graphlily_tpu_torch.ops.chunked import chunk_entries, entry_slots
from graphlily_tpu_torch.ops.planar import tile_columns

from test_torch_fixtures import (CHUNKED_FIXTURES, FIXTURES, PLANAR_FIXTURES,
                                 hub_window_csr)
from test_torch_router import CPU, _references
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
