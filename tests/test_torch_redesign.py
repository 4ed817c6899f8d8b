"""The device forms that the chunked kernel (K6/K7, K7p), K4 fused and
K4p fused, K1 (and K1p) and K8 read, derived at engine init from the
packed layouts, and their plain versions, on the CPU.

Chunked (`ops/chunked.chunk_entries`): every real entry of the layout
appears once and no padding slot does, for both pad values and both chunk
orders, which give the same form; the block table tiles the entries with
ranges inside one window group, and walking it as the kernel does covers
every entry once, in its own segment. Planar (`PlanarSpMV.element_index`):
each element's column equals the chained a_r -> a_sub gather read from
the layout. The plain versions over the derived forms equal the plain
versions over the layouts (bit for bit for ANDOR and ADDMIN, and for
`fused_plain` in every semiring: it adds through the flush stream), JAX
`spmv_coo` on the padded graph and the float64 oracle, with the
tolerances of test_torch_chunked.py and test_torch_planar.py.

K4 fused's row-sorted form (`ops/router.router_entries` over
`PlanarSpMV.element_index`): on the "free", "bucket" and PERM-C layouts
it holds exactly the CSR's (row, col, value) triples, each deposited
element once; the forms of one graph's three layouts are equal array for
array; its blocks cover the elements once at two block sizes and with
several column windows; the CPU walk (`fused_spmv` on CPU tensors)
matches `fused_plain`, JAX `spmv_coo` and the float64 oracle (ANDOR
bit-equal, MULADD within 1e-5 * max|ref|); the ANDOR form without values
walks to the same y; PageRank and BFS through the public API on the
fused planar engine ("free" and PERM-C) equal the JAX apps.

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
                                     TropicalStages)
from graphlily_tpu_torch.ops.chunked import chunk_entries, entry_slots
from graphlily_tpu_torch.ops.planar import (FORM_COL_BITS,
                                            FORM_COL_BITS_NO_VALUES)
from graphlily_tpu_torch.ops.router import router_entries
from graphlily_tpu_torch.ops.tropical import split_pieces

from test_torch_fixtures import (CHUNKED_FIXTURES, FIXTURES, PLANAR_FIXTURES,
                                 TROPICAL_FIXTURES, hub_window_csr,
                                 one_thread, stored_zeros_csr)
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


# ---- planar: the element index's columns ------------------------------------
def _planar(name, deal):
    build, region_rows = PLANAR_CASES[name]
    csr = build()
    if deal == "permc":
        return csr, pack_permc(csr, region_rows=region_rows)
    return csr, pack_planar(csr, region_rows=region_rows, deal=deal)


@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_tile_column_equals_the_chained_gather(name, deal):
    """Every deposited element's column in the plain index, from which
    the engine derives its forms, is the chained gather read straight
    from the layout at its A slot (c, s, l) with r = a_r[c, s, l]:
    a_page[c]*1024 + a_sub[c, s, r]*128 + r ("free", PERM-C) or
    a_page[c]*1024 + s*128 + r into K5's x2 ("bucket"); its unit is the
    chunk's tile, and each element appears once."""
    _, lay = _planar(name, deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    idx = eng.plain_index()
    src = idx["src"].numpy()
    chunk, s = src // 1024, src % 1024 // 128
    r = lay.a_r.reshape(-1)[src].astype(np.int64)
    sub = (s if lay.a_sub is None else
           lay.a_sub.reshape(-1)[chunk * 1024 + s * 128 + r].astype(np.int64))
    page = lay.a_page.reshape(-1)[chunk].astype(np.int64)
    np.testing.assert_array_equal(idx["col"].numpy(),
                                  page * 1024 + sub * 128 + r)
    np.testing.assert_array_equal(idx["unit"].numpy(), page)
    assert len(src) == lay.nnz == len(np.unique(src))


@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("fixture", list(PLANAR_CASES))
def test_fused_plain_matches_composed_plain_and_references(fixture, deal,
                                                           name):
    """`fused_plain`, the gather through the flush stream (the reference
    of K4 fused and K4p fused), equals K4 scatter -> K3's plain versions
    bit for bit (it adds in flush-stream order), and the engine call equals
    JAX spmv_coo and the float64 oracle; at a frontier of half the tiles
    it equals the composed one with the same activity."""
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


# ---- K4 fused: the planar layouts' row-sorted element form -----------------
def _csr_triples(csr):
    """(row, col, value) of every stored entry, sorted by (row, col,
    value): RMAT graphs hold repeated (row, col) pairs."""
    nnz = csr.nnz
    rows = csr.row_ids().astype(np.int64)
    cols = csr.adj_indices[:nnz].astype(np.int64)
    vals = csr.adj_data[:nnz].astype(np.float32)
    order = np.lexsort((vals, cols, rows))
    return rows[order], cols[order], vals[order]


@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar_form_holds_the_csr_triples(name, deal):
    """K4 fused's form holds every deposited element once, and its
    expansion is the matrix's (row, col, value) triples, sorted by row
    within each region and column window; a "bucket" element's x2 slot is
    resolved to its x column."""
    csr, lay = _planar(name, deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    e = eng.entries
    assert e.order == "row" and e.vals.numel() == lay.nnz == csr.nnz
    assert e.col_bits == min(FORM_COL_BITS,
                             31 - int(eng.region_rows - 1).bit_length())
    bare = PlanarSpMV(lay, tg.LogicalSemiring, CPU).entries
    assert bare.vals is None and bare.col_bits == min(
        FORM_COL_BITS_NO_VALUES, 31 - int(eng.region_rows - 1).bit_length())
    col, row, _ = (t.numpy() for t in eng.entries_index())
    val = e.vals.numpy()
    rows, cols, vals = _csr_triples(csr)
    key = (row // eng.region_rows * ((eng.num_cols >> e.col_bits) + 1) + (
        col >> e.col_bits)) * eng.out_len + row
    assert (np.diff(key) >= 0).all()
    order = np.lexsort((val, col, row))
    np.testing.assert_array_equal(row[order], rows)
    np.testing.assert_array_equal(col[order], cols)
    np.testing.assert_array_equal(val[order], vals)
    idx = eng.plain_index()
    assert len(idx["src"]) == lay.nnz == len(np.unique(idx["src"]))
    assert set(idx) == {"src", "col", "dst", "unit", "dep", "row"}
    np.testing.assert_array_equal(
        idx["dep"].numpy(), np.repeat(np.arange(int(idx["dep"].max()) + 1),
                                      np.bincount(idx["dep"].numpy())))


@pytest.mark.parametrize("name", list(PLANAR_CASES))
def test_planar_forms_equal_across_deals(name):
    """The forms derived from the "free", "bucket" and PERM-C layouts of
    one graph are equal array for array: they hold the triples and
    nothing of the deal."""
    forms = {}
    for deal in LAYOUTS:
        _, lay = _planar(name, deal)
        forms[deal] = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU).entries
    a = forms["free"]
    for deal in ("bucket", "permc"):
        b = forms[deal]
        for field in ("vals", "idx", "deps", "blocks"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          getattr(b, field).numpy(),
                                          f"{deal} {field}")
        assert (a.max_segments, a.col_bits) == (b.max_segments, b.col_bits)


@pytest.mark.parametrize("col_bits", [None, 10], ids=["window", "narrow"])
@pytest.mark.parametrize("block_entries", [100, 4096])
@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("name", ["rmat", "hub_columns"])
def test_planar_form_blocks_cover_the_elements_once(name, deal,
                                                    block_entries, col_bits):
    """The planar form's blocks tile its elements as the kernel walks
    them, at two block sizes, with one column window per region or with
    windows of 1,024 columns (several per region)."""
    _, lay = _planar(name, deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    eng.use_entries(router_entries(eng, "row", block_entries, col_bits))
    if col_bits is not None:
        assert eng.entries.deps.shape[0] > lay.num_regions
    _assert_blocks_cover(eng, block_entries)


@pytest.mark.parametrize("name", ["arithmetic", "logical"])
@pytest.mark.parametrize("deal", LAYOUTS)
@pytest.mark.parametrize("fixture", list(PLANAR_CASES))
def test_planar_fused_walk_matches_fused_plain_and_references(fixture, deal,
                                                              name):
    """K4 fused on CPU tensors walks its form: against `fused_plain` (K4
    scatter -> K3's plain versions through the flush stream), JAX
    spmv_coo on the padded graph and the float64 oracle, ANDOR bit-equal
    and MULADD within 1e-5 * max|ref|; it needs no K5."""
    csr, lay = _planar(fixture, deal)
    eng = PlanarSpMV(lay, tg.SEMIRINGS[name], CPU)
    x, mask = test_torch_router._vectors(lay)
    xt = torch.from_numpy(x)
    y = eng.fused_spmv(xt)
    np.testing.assert_array_equal(y.numpy(), eng.fused_entries_plain(xt))
    old = eng.fused_plain(xt)
    want, want64 = _references(csr, name, x, mask, tg.MaskType.NO_MASK)
    n = lay.num_rows
    if name == "logical":
        assert torch.equal(y.view(torch.int32), old.view(torch.int32))
    else:
        assert (y - old).abs().max() <= 1e-5 * old.abs().max()
    clamped = (y[:n] != 0).to(torch.float32) if name == "logical" else y[:n]
    test_torch_router._assert_matches(clamped, want, want64, name)
    assert not any(eng.launches.values())


@pytest.mark.parametrize("deal", LAYOUTS)
def test_planar_fused_walk_on_edge_inputs(deal):
    """An all-zero x gives a zero y; x = 1 gives each row's sum of
    values, zero on rows without entries."""
    csr, lay = _planar("region_1024", deal)
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    assert not eng.fused_spmv(torch.zeros(lay.num_cols)).any()
    y = eng.fused_spmv(torch.ones(lay.num_cols))
    want = np.bincount(csr.row_ids(), csr.adj_data[:csr.nnz].astype(
        np.float64), minlength=eng.out_len)
    assert np.abs(y.numpy() - want).max() <= 1e-5 * want.max()


def test_planar_form_refuses_unfilled_x2_slots():
    """A "bucket" element whose x2 slot no xperm plane fills cannot be
    resolved to an x column: the form raises instead of reading 0."""
    _, lay = _planar("rmat", "bucket")
    eng = PlanarSpMV(lay, tg.ArithmeticSemiring, CPU)
    col = eng.element_index(eng.arrays)["col"]
    xp = eng.arrays.xperm.view(-1, 8, 1024)
    t, d = int(col[0]) // 1024, int(col[0]) % 1024
    xp[t, :, d] = 0                     # no plane takes that slot now
    with pytest.raises(ValueError, match="x2 slot"):
        router_entries(eng, "row")


def test_andor_form_without_values():
    """ANDOR engines build K4 fused's form without its value stream where
    every stored value is nonzero; its walk equals the form with values'.
    The form without values refuses MULADD, and, asked for by name, a
    stored zero instead of counting it; the engine then keeps the values
    (test_andor_form_keeps_values_for_stored_zeros)."""
    csr, lay = _planar("hub_columns", "free")
    eng = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    assert eng.entries.vals is None
    assert eng.entries.nbytes() < PlanarSpMV(
        lay, tg.ArithmeticSemiring, CPU).entries.nbytes()
    x, _ = test_torch_router._vectors(lay)
    xt = torch.from_numpy(x)
    y = eng.fused_spmv(xt)
    eng.use_entries(router_entries(eng, "row", col_bits=eng.entries.col_bits))
    assert eng.entries.vals is not None
    assert torch.equal(eng.fused_spmv(xt).view(torch.int32),
                       y.view(torch.int32))
    with pytest.raises(ValueError, match="ANDOR"):
        router_entries(PlanarSpMV(lay, tg.ArithmeticSemiring, CPU), "row",
                       values=False)
    lay.a_vals.reshape(-1)[eng.plain_index()["src"][5].item()] = 0.0
    zeroed = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    assert zeroed.entries.vals is not None
    with pytest.raises(ValueError, match="zero"):
        router_entries(zeroed, "row", values=False)


@pytest.mark.parametrize("deal", LAYOUTS)
def test_andor_form_keeps_values_for_stored_zeros(deal):
    """An ANDOR engine over a matrix with explicit zeros keeps K4 fused's
    value stream, at the windows of the form with values, so that
    v != 0 && x != 0 counts no edge there: its walk equals `fused_plain`
    bit for bit, and the engine call and the module's product equal JAX
    spmv_coo and the float64 oracle, which differ from the same graph's
    with every value 1."""
    from graphlily_tpu_torch.module import SpMVModule
    csr = stored_zeros_csr()
    lay = (pack_permc(csr) if deal == "permc"
           else pack_planar(csr, deal=deal))
    eng = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    e = eng.entries
    assert e.vals is not None and (e.vals.numpy() == 0).any()
    assert e.col_bits == min(FORM_COL_BITS,
                             31 - int(eng.region_rows - 1).bit_length())
    x, mask = test_torch_router._vectors(lay)
    xt = torch.from_numpy(x)
    y = eng.fused_spmv(xt)
    assert torch.equal(y.view(torch.int32),
                       eng.fused_plain(xt).view(torch.int32))
    refs = _references(csr, "logical", x, mask, tg.MaskType.NO_MASK)
    ones = csr.copy()
    ones.adj_data[:] = 1.0
    assert (refs[0] != _references(ones, "logical", x, mask,
                                   tg.MaskType.NO_MASK)[0]).any()
    test_torch_router._assert_matches(eng(xt), *refs, "logical")
    mod = SpMVModule(tg.EngineConfig(engine="planar", device="cpu",
                                     planar_deal=deal))
    mod.set_semiring(tg.LogicalSemiring)
    mod.load_and_format_matrix(csr)
    assert mod.engine_name == "planar" and mod.engine.entries.vals is not None
    test_torch_router._assert_matches(mod.apply(xt), *refs, "logical")
    assert not any(eng.launches.values())


@pytest.mark.parametrize("deal", ["free", "permc"])
@pytest.mark.parametrize("app_name", ["pagerank", "bfs"])
def test_planar_fused_apps_match_jax(app_name, deal):
    """PageRank and BFS pull through the public API on the fused planar
    engine (its form walked on the CPU) equal the JAX apps: PageRank
    within rtol 1e-5, BFS exactly."""
    from graphlily_tpu.apps import BFS as JaxBFS, PageRank as JaxPageRank
    from graphlily_tpu_torch.apps import BFS, PageRank
    from graphlily_tpu_torch.io import rmat_csr
    g = rmat_csr(50000, 150000, seed=5)
    cfg = tg.EngineConfig(engine="planar", sort_rows_by_degree=True,
                          device="cpu", planar_deal=deal)
    jcfg = jg.EngineConfig(engine="xla")
    if app_name == "pagerank":
        app, jax_app = PageRank(cfg), JaxPageRank(jcfg)
        app.load_and_format_matrix(g, 0.9)
        jax_app.load_and_format_matrix(to_jax(g), 0.9)
        got, want = app.pull(0.9, 10), np.asarray(jax_app.pull(0.9, 10))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        app, jax_app = BFS(cfg), JaxBFS(jcfg)
        app.load_and_format_matrix(g)
        jax_app.load_and_format_matrix(to_jax(g))
        got, want = app.pull(3, 8), np.asarray(jax_app.pull(3, 8))
        np.testing.assert_array_equal(got, want)
        assert (want > 0).sum() > 1
    eng = app.SpMV_.engine
    assert app.SpMV_.engine_name == "planar" and eng.fused
    assert eng.permc == (deal == "permc")
    assert eng.entries.idx.numel() == eng.nnz


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
    row order sorts each (region, column window) by (row, column) and
    repeated pairs by value."""
    order, col_bits = ROUTER_FORMS[form]
    _, lay, eng = _router(name, order=order, col_bits=col_bits)
    e = eng.entries
    idx = eng.plain_index()
    live = idx["row"][idx["dst"]] < eng.out_len
    src, col = idx["src"][live], idx["col"][live]
    row = idx["row"][idx["dst"]][live]
    assert e.vals.numel() == len(src) == lay.nnz
    got_col, got_row, flag = eng.entries_index()
    if order == "row":   # repeated (row, column) pairs in value order
        window = col >> e.col_bits
        region = row // eng.region_rows
        perm = torch.argsort(eng.arrays.a_vals[src].view(torch.int32),
                             stable=True)
        perm = perm[torch.argsort((((region * (window.max() + 1) + window)
                                    * eng.out_len + row) * eng.num_cols
                                   + col)[perm], stable=True)]
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
    _assert_blocks_cover(eng, block_entries,
                         1024 if order == "deposit" else None)


def _assert_blocks_cover(eng, block_entries, width=None):
    """The block table of `eng.entries` tiles its elements as the kernel
    walks them, each element once in its own segment, and each segment's
    record holds its column window (`width` columns; the form's window
    when None) and its region."""
    e = eng.entries
    blocks = e.blocks.numpy().astype(np.int64)
    n = e.idx.numel()
    start = np.r_[e.deps[:, 0].numpy().astype(np.int64), n]
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
    width = 2 ** e.col_bits if width is None else width
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
    return lay, TropicalStages(lay, CPU)


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
