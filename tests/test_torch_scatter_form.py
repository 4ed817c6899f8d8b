"""The planar engine's store form (K4 scatter and K4p scatter) and tile form
(K4p fused), derived at engine init, and their plain walks, on the CPU.

Store form (`ops/router.router_entries(eng, "stream")`): every deposited
element once, with its own value, x column (a "bucket" x2 slot resolved
to x) and flush-stream position, one segment a piece flagged by its tile,
and the `tails` of every (flush chunk, sublane), whose elements fill a
prefix of its lanes. Its walk (`scatter_entries_plain`, the CPU path of
`scatter` and `scatter_predicated`) equals `scatter_plain` through the
layout bit for bit: MULADD and ANDOR on the "free", "bucket" and PERM-C
layouts, the tropical pass 1's ADDMIN int32 encodings on "free" and
"bucket", each on a full x and at empty, one-vertex and 5% frontiers; a
"bucket" walk never runs K5's plain version.

Tile form (`pred_entries`, windows of one 1,024-column tile): the same
arrays on the three deals of one graph, the value stream kept for stored
zeros, and its walk (`fused_predicated` on CPU tensors) equal, on a
frontier of a third of the tiles, to JAX spmspv_coo on the padded graph
and the float64 oracle (ANDOR bit for bit after the 0/1 clamp, MULADD
within 1e-4 * max|y64|) and to K4 fused's walk bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.io import matrix as jmatrix

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import (pack_planar, pack_permc, pack_tropical,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.ops import PlanarSpMV, TropicalStages
from graphlily_tpu_torch.ops.router import entries_index
from graphlily_tpu_torch.module import SpMVModule

from test_torch_fixtures import (FIXTURES, TROPICAL_FIXTURES, one_thread,
                                 stored_zeros_csr)
from test_torch_io import to_jax

CPU = tg.EngineConfig(device="cpu")
CASES = ["uniform", "rmat", "multi_region", "hub_page"]
DEALS = ["free", "bucket", "permc"]
KINDS = ["full", "empty", "one", "5pct"]
SEMIRINGS = ["arithmetic", "logical"]


@functools.cache
def _csr(name):
    return FIXTURES[name][0]()


@functools.cache
def _engine(name, deal, semiring):
    csr = _csr(name)
    lay = pack_permc(csr) if deal == "permc" else pack_planar(csr, deal=deal)
    return PlanarSpMV(lay, tg.SEMIRINGS[semiring], CPU)


@functools.cache
def _tropical(name, deal):
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    lay = pack_tropical(build(), tg.EngineConfig(planar_deal=deal),
                        region_rows=region_rows, kb=kb, split_format="planes")
    return TropicalStages(lay, CPU)


def _x(ncols, kind, zero, seed=3):
    """A full x (a third of it the semiring zero) or a frontier: no
    entry, one column, or 5% of the columns, values >= 0.5."""
    rng = np.random.default_rng(seed)
    if kind == "full":
        x = rng.random(ncols).astype(np.float32) + 0.5
        x[rng.random(ncols) < 0.3] = zero
        return torch.from_numpy(x)
    k = {"empty": 0, "one": 1, "5pct": ncols // 20}[kind]
    x = np.full(ncols, zero, np.float32)
    x[rng.choice(ncols, size=k, replace=False)] = rng.random(k) + 0.5
    return torch.from_numpy(x)


def _act(x, zero):
    return (x.reshape(-1, 1024) != zero).any(1).to(torch.uint8)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# ---- the store form ----------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", CASES)
def test_store_walk_equals_scatter_plain(name, deal, semiring, kind):
    """K4 scatter's walk of its store form (K4p scatter's on a frontier)
    equals the plain version through the layout bit for bit; on a
    frontier also the unpredicated walk."""
    eng = _engine(name, deal, semiring)
    x = _x(eng.num_cols, kind, 0.0)
    act = None if kind == "full" else _act(x, 0.0)
    s = (eng.scatter(x) if act is None else eng.scatter_predicated(x, act))
    assert _same_bits(s, eng.scatter_plain(x, None, act))
    if act is not None:
        assert _same_bits(s, eng.scatter(x))
    if kind == "empty":
        assert not s.any()
    assert not any(eng.launches.values())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("name", ["multi_region", "hub_row"])
def test_tropical_store_walk_equals_scatter_plain(name, deal, kind):
    """The tropical pass 1's int32 encodings (ADDMIN, x >= 0 with
    FLOAT_INF off the frontier) through the store form equal the plain
    version through the layout, and K4p scatter's the unpredicated one:
    skipped pieces hold 0, the encoding of FLOAT_INF."""
    eng = _tropical(name, deal)
    inf = float(tg.FLOAT_INF)
    x = _x(eng.walk.num_cols, kind, inf) * 100
    x[x == inf * 100] = inf
    act = None if kind == "full" else eng.walk.activity(x)
    g1 = eng.scatter(x) if act is None else eng.scatter_predicated(x, act)
    assert g1.dtype == torch.int32
    assert _same_bits(g1, eng.scatter_plain(x, act))
    if act is not None:
        assert _same_bits(g1, eng.scatter(x))
    assert eng.walk.planar.store_entries.tails is not None


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", CASES)
def test_store_form_holds_every_element_once(name, deal):
    """Every deposited element once, with its value, x column and stream
    position; segments are pieces in slot order, each flagged by its tile
    with x offset the tile's first column and stream offset its target
    chunk's first position; the tails count each (chunk, sublane)'s
    elements, which fill its first lanes; blocks tile the elements."""
    eng = _engine(name, deal, "arithmetic")
    e = eng.store_entries
    idx = eng.plain_index()
    col, dst, flag = (t.numpy() for t in entries_index(e))
    assert e.order == "stream" and e.col_bits == 10
    assert len(dst) == eng.nnz == len(np.unique(dst))
    np.testing.assert_array_equal(dst, idx["dst"].numpy())
    np.testing.assert_array_equal(col, eng.x_columns(idx["col"]).numpy())
    np.testing.assert_array_equal(flag, idx["unit"].numpy())
    np.testing.assert_array_equal(
        e.vals.numpy(), eng.arrays.a_vals[idx["src"]].numpy())
    deps = e.deps.numpy().astype(np.int64)
    _, dep = np.unique(idx["dep"].numpy(), return_inverse=True)
    assert len(deps) == dep.max() + 1       # the pieces with elements
    np.testing.assert_array_equal(deps[dep, 1], col // 1024 * 1024)
    np.testing.assert_array_equal(deps[dep, 2], dst // 1024 * 1024)
    count = np.bincount(dst // 128, minlength=eng.nsteps * eng.f * 8)
    np.testing.assert_array_equal(e.tails.numpy(), count)
    lane_end = np.zeros_like(count)
    np.maximum.at(lane_end, dst // 128, dst % 128 + 1)
    np.testing.assert_array_equal(lane_end, count)
    blocks = e.blocks.numpy()
    assert blocks[0, 0] == 0 and blocks[-1, 1] == len(dst)
    np.testing.assert_array_equal(blocks[1:, 0], blocks[:-1, 1])


@pytest.mark.parametrize("name", CASES)
def test_bucket_store_walk_needs_no_xperm(name):
    """A "bucket" engine's store form reads x directly: its walk runs
    without K5's plain version and equals K5 -> gather's stream."""
    eng = _engine(name, "bucket", "arithmetic")
    x = _x(eng.num_cols, "full", 0.0)
    want = eng.scatter_plain(x)

    def refused(*a, **kw):
        raise AssertionError("the store form's walk ran K5")
    eng.xperm_plain = refused
    try:
        assert _same_bits(eng.scatter(x), want)
    finally:
        del eng.xperm_plain


def test_store_form_without_prefix_lanes_has_no_tails():
    """Elements that leave a hole below a filled lane of their (chunk,
    sublane) give no tails: the wrapper then zeroes the whole stream."""
    from graphlily_tpu_torch.ops.router import stream_tails
    dst = torch.tensor([0, 1, 2, 128, 130, 1024])
    assert stream_tails(dst, 2) is None
    tails = stream_tails(torch.tensor([0, 1, 2, 128, 129, 1024]), 2)
    np.testing.assert_array_equal(tails.numpy(),
                                  [3, 2, 0, 0, 0, 0, 0, 0, 1] + [0] * 7)


# ---- the tile form -------------------------------------------------------------
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("name", CASES)
def test_tile_form_equal_across_deals(name, semiring):
    """The tile forms of one graph's "free", "bucket" and PERM-C layouts
    are equal array for array: one segment per (region, tile), flagged
    by its tile."""
    forms = [_engine(name, deal, semiring).pred_entries for deal in DEALS]
    a = forms[0]
    assert a.col_bits == 10 and a.order == "row"
    np.testing.assert_array_equal(a.deps[:, 3].numpy(),
                                  a.deps[:, 1].numpy() // 1024)
    for b in forms[1:]:
        for field in ("vals", "idx", "deps", "blocks"):
            fa, fb = getattr(a, field), getattr(b, field)
            assert (fa is None) == (fb is None), field
            if fa is not None:
                np.testing.assert_array_equal(fa.numpy(), fb.numpy(), field)
        assert a.max_segments == b.max_segments


@pytest.mark.parametrize("deal", DEALS)
def test_tile_form_keeps_values_for_stored_zeros(deal):
    """An ANDOR engine over explicit zeros keeps the tile form's value
    stream, so v != 0 && x != 0 counts no edge there: K4p fused's walk
    equals K4p scatter -> K3's plain versions bit for bit."""
    csr = stored_zeros_csr()
    lay = pack_permc(csr) if deal == "permc" else pack_planar(csr, deal=deal)
    eng = PlanarSpMV(lay, tg.LogicalSemiring, CPU)
    e = eng.pred_entries
    assert e.vals is not None and (e.vals.numpy() == 0).any()
    x = _x(eng.num_cols, "5pct", 0.0)
    act = eng.activity(x)
    assert _same_bits(eng.fused_predicated(x, act),
                      eng.fused_plain(x, None, act))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", ["rmat", "multi_region"])
def test_tile_walk_matches_spmspv_coo(name, deal, semiring):
    """K4p fused's walk of the tile form over a third of the tiles equals
    JAX spmspv_coo on the padded graph and the float64 oracle (ANDOR bit
    for bit after the clamp, MULADD within 1e-4 * max|y64|), and K4 fused's
    walk on the same x bit for bit."""
    eng = _engine(name, deal, semiring)
    csr = _csr(name)
    rng = np.random.default_rng(5)
    on = np.repeat(rng.random(eng.num_act) < 0.34, 1024)
    x = (rng.random(eng.num_cols).astype(np.float32) + 0.5) * on
    x[rng.random(eng.num_cols) < 0.5] = 0.0
    xt = torch.from_numpy(x)
    act = eng.activity(xt)
    y = eng.fused_predicated(xt, act)
    assert _same_bits(y, eng.fused_spmv(xt))
    got = eng.call_predicated(xt).numpy()
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, 1024, 1024)
    idx = np.flatnonzero(x)
    _, want = jops.spmspv_coo(
        jops.coo_from_csc(jmatrix.csr2csc(to_jax(padded))),
        jops.sparse_from_entries(idx, x[idx], capacity=len(x)),
        jg.SEMIRINGS[semiring])
    want = np.asarray(want)[:len(got)]
    mod = SpMVModule(tg.EngineConfig(engine="xla", device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.load_and_format_matrix(padded)
    want64 = mod.compute_reference_results(x[:padded.num_cols])[:len(got)]
    if semiring == "logical":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.astype(np.float64), want64)
    else:
        scale = np.abs(want64).max()
        for ref in (want.astype(np.float64), want64):
            assert np.abs(got - ref).max() <= 1e-4 * scale
    assert not any(eng.launches.values())
