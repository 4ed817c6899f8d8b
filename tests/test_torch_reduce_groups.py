"""Phase C's region-group table (ops/router.reduce_groups), which K3 and
K11 read, on the CPU, against the JAX package.

On the roll layout and the "free", "bucket" and PERM-C planar layouts of
the JAX tests' fixtures (uniform, RMAT, multi-region, hub page and 20
regions of 1,024 rows; RMAT, 1,024-row regions, hub columns, uniform):

  * the table's invariants: every flushed chunk once, sorted stably by
    region; each group one region's consecutive chunks, at most the group
    size; the sole-group flag set exactly where the region has one group;
    at the default group size and at 1 and 2 chunks a group, so that split
    regions and sole groups both occur, also with REDUCE_GROUP_CHUNKS
    monkeypatched, which the engine's init reads;
  * the group walk, the kernel's reading of the table emulated here (each
    group's slots summed in a tile of its region's rows, the tiles then
    stored or added into y), against `reduce_plain` (the reference, and
    `reduce`'s CPU path): ANDOR bit-equal, MULADD within 1e-5 * max|y|;
    on PERM-C, where K11 is K3's kernel over the position-keyed rows, the
    destination-lane run map (what K11p reads) equals those rows on every
    flushed slot that a run covers, and every slot no run covers holds
    row 0 and a zero product;
  * the split branch (`fused = False`) through `SpMVModule` against JAX
    `spmv_coo` and the float64 oracle, under all three mask types: ANDOR
    bit-equal, MULADD within 1e-5 * max|ref| (fp32 rounding in another
    order; test_torch_router.py's tolerance);
  * the empty matrix: an empty table and y = 0, as JAX's `spmv_coo`
    gives;
  * `reduce(stream, arrays=<another layout's arrays>)` raises.

Inputs come from numpy seeds; nothing in the JAX package changes.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import (csr_from_coo, pack_permc, pack_planar,
                                    pack_router, util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule
from graphlily_tpu_torch.ops import PlanarSpMV, RouterSpMV, router
from graphlily_tpu_torch.ops.router import reduce_groups

from test_torch_fixtures import FIXTURES, PLANAR_FIXTURES, one_thread
from test_torch_io import to_jax
from test_torch_router import (CPU, MASKS, _assert_matches, _references,
                               _vectors)

ROLL = ["uniform", "rmat", "multi_region", "hub_page", "region_1024"]
PLANAR = ["rmat", "region_1024", "hub_columns", "uniform"]
LAYOUTS = ([("roll", n) for n in ROLL]
           + [(deal, n) for deal in ("free", "bucket", "permc")
              for n in PLANAR])
LAYOUT_IDS = [f"{deal}-{n}" for deal, n in LAYOUTS]
SEMIRINGS = ["arithmetic", "logical"]


@functools.cache
def _layout(deal, name):
    if deal == "roll":
        build, region_rows = FIXTURES[name]
        return pack_router(build(), region_rows=region_rows)
    build, region_rows = PLANAR_FIXTURES[name]
    if deal == "permc":
        return pack_permc(build(), region_rows=region_rows)
    return pack_planar(build(), region_rows=region_rows, deal=deal)


@functools.cache
def _engine(deal, name, semiring):
    cls = RouterSpMV if deal == "roll" else PlanarSpMV
    return cls(_layout(deal, name), tg.SEMIRINGS[semiring], CPU)


def _with_groups(eng, group_chunks):
    """`eng` sharing its arrays, over a table of `group_chunks` chunks a
    group (the engine's own when None)."""
    if group_chunks is None:
        return eng
    v = copy.copy(eng)
    v.groups = reduce_groups(eng.arrays.c_code, group_chunks)
    return v


def _group_walk(eng, stream) -> torch.Tensor:
    """Phase C as K3 and K11 read the table, in float32: each group's
    flushed slots (its chunks of `order`) summed into a zeroed tile of its
    region's rows c_hi*128 + c_lo, then the tiles into y: a region's only
    group stores its tile, the others add theirs. Which slots are summed,
    and where, comes from the table alone."""
    g = eng.groups.groups.long()
    order = eng.groups.order.long()
    rr = eng.region_rows
    pos = (order[:, None] * 1024 + torch.arange(1024)).reshape(-1)
    row = eng.arrays.c_hi[pos].long() * 128 + eng.arrays.c_lo[pos].long()
    gid = torch.repeat_interleave(torch.arange(len(g)), g[:, 1] * 1024,
                                  output_size=pos.numel())
    tiles = torch.zeros(len(g) * rr).index_add_(
        0, gid * rr + row, stream.reshape(-1)[pos]).reshape(len(g), rr)
    y = torch.zeros(eng.num_regions, rr)
    sole = g[:, 3] == 1
    y[g[sole, 2]] = tiles[sole]
    y.index_add_(0, g[~sole, 2], tiles[~sole])
    return y.reshape(-1)


def _assert_walk_matches(got, want, semiring):
    if semiring == "logical":
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
    else:
        scale = float(want.abs().max()) if want.numel() else 0.0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def _check_table(groups, c_code, group_chunks):
    order = groups.order.long().numpy()
    g = groups.groups.long().numpy()
    code = c_code.long().numpy()
    live = np.flatnonzero(code >= 0)
    # every flushed chunk once, sorted stably by region
    np.testing.assert_array_equal(np.sort(order), live)
    np.testing.assert_array_equal(order, live[np.argsort(code[live],
                                                         kind="stable")])
    assert g.shape == (len(g), 4) and groups.groups.dtype == torch.int32
    if not len(live):
        assert len(g) == 0
        return
    # the groups cut `order` into consecutive runs of one region each
    np.testing.assert_array_equal(g[:, 0], np.cumsum(g[:, 1]) - g[:, 1])
    assert g[:, 1].sum() == len(order)
    assert (g[:, 1] >= 1).all() and (g[:, 1] <= group_chunks).all()
    rid = np.repeat(np.arange(len(g)), g[:, 1])
    np.testing.assert_array_equal(code[order], g[rid, 2])
    # a region's groups are full but its last, and sole where it has one
    regions, count = np.unique(g[:, 2], return_counts=True)
    sole = dict(zip(regions, count == 1))
    np.testing.assert_array_equal(g[:, 3], [sole[r] for r in g[:, 2]])
    for r in regions:
        sizes = g[g[:, 2] == r, 1]
        assert (sizes[:-1] == group_chunks).all()
    assert groups.nbytes() == 4 * len(order) + 16 * len(g)


@pytest.mark.parametrize("group_chunks", [None, 1, 2],
                         ids=["default", "1", "2"])
@pytest.mark.parametrize("deal,name", LAYOUTS, ids=LAYOUT_IDS)
def test_table_invariants(deal, name, group_chunks):
    eng = _with_groups(_engine(deal, name, "logical"), group_chunks)
    _check_table(eng.groups, eng.arrays.c_code,
                 group_chunks or router.REDUCE_GROUP_CHUNKS)


# (layout, group size): at 1 chunk a group every region here is split; at
# the others some regions are split and some have one group
PATCHED = [("roll", "multi_region", 1), ("roll", "region_1024", 2),
           ("free", "region_1024", 2), ("bucket", "region_1024", 2),
           ("permc", "region_1024", 16)]


@pytest.mark.parametrize("deal,name,group_chunks", PATCHED,
                         ids=[f"{d}-{n}-{k}" for d, n, k in PATCHED])
def test_engine_reads_the_group_size(deal, name, group_chunks, monkeypatch):
    """With REDUCE_GROUP_CHUNKS monkeypatched down, the engine's init cuts
    its table at that size (regions of several groups and sole groups both
    occur above one chunk a group), and the group walk over it still
    equals the reference."""
    monkeypatch.setattr(router, "REDUCE_GROUP_CHUNKS", group_chunks)
    lay = _layout(deal, name)
    eng = (RouterSpMV if deal == "roll" else PlanarSpMV)(
        lay, tg.ArithmeticSemiring, CPU)
    _check_table(eng.groups, eng.arrays.c_code, group_chunks)
    sole = eng.groups.groups[:, 3]
    assert bool((sole == 0).any())
    assert bool((sole == 1).any()) == (group_chunks > 1)
    x, _ = _vectors(eng)
    s = eng.scatter(torch.from_numpy(x))
    _assert_walk_matches(_group_walk(eng, s), eng.reduce_plain(s),
                         "arithmetic")


@pytest.mark.parametrize("group_chunks", [None, 2], ids=["default", "2"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("deal,name", LAYOUTS, ids=LAYOUT_IDS)
def test_group_walk_matches_plain(deal, name, semiring, group_chunks):
    eng = _with_groups(_engine(deal, name, semiring), group_chunks)
    x, _ = _vectors(eng)
    s = eng.scatter(torch.from_numpy(x))
    want = eng.reduce(s)                   # on the CPU: reduce_plain
    assert sum(eng.launches.values()) == 0
    np.testing.assert_array_equal(want.numpy(), eng.reduce_plain(s).numpy())
    got = _group_walk(eng, s)
    _assert_walk_matches(got, want, semiring)
    if semiring == "logical":    # 0/1 counts of edges to x != 0
        assert float(got.sum()) == float((s != 0).sum())


def _run_rows(a) -> torch.Tensor:
    """PERM-C's destination-lane run map, what K11p reads: the positions
    c_beg+1 .. c_end of sublane s of a chunk get row hi*128 + v from lane
    v's keys; -1 where no run covers a position."""
    end, beg = a.c_end.long(), a.c_beg.long()
    k = torch.nonzero(end > beg).flatten()     # (q*8 + s)*128 + v
    n = end[k] - beg[k]
    v = k % 128
    rep = torch.repeat_interleave(torch.arange(k.numel()), n)
    off = torch.arange(rep.numel()) - (torch.cumsum(n, 0) - n)[rep]
    rows = torch.full_like(end, -1)
    rows[(k - v + beg[k] + 1)[rep] + off] = (a.c_hi_dest[k].long() * 128
                                             + v)[rep]
    return rows


@pytest.mark.parametrize("name", PLANAR)
def test_permc_run_map_equals_row_map(name):
    """K11p's destination-lane run map against the position-keyed rows
    that K11 (K3's kernel) reads through the group table, on every flushed
    slot."""
    eng = _engine("permc", name, "arithmetic")
    a = eng.arrays
    runs = _run_rows(a)
    assert int((runs >= 0).sum()) == eng.nnz
    runs = runs.reshape(-1, 1024)
    rows = (a.c_hi.long() * 128 + a.c_lo.long()).reshape(-1, 1024)
    flushed = a.c_code >= 0
    assert int((runs[~flushed] >= 0).sum()) == 0     # none unflushed
    runs, rows = runs[flushed], rows[flushed]
    covered = runs >= 0
    np.testing.assert_array_equal(runs[covered].numpy(),
                                  rows[covered].numpy())
    assert not rows[~covered].any()
    x, _ = _vectors(eng)
    s = eng.scatter(torch.from_numpy(x)).reshape(-1, 1024)[flushed]
    assert not s[~covered].any()


@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("engine,deal", [("roll", "free"), ("planar", "free"),
                                         ("planar", "bucket"),
                                         ("planar", "permc")],
                         ids=["roll", "free", "bucket", "permc"])
def test_split_module_matches_jax_and_oracle(engine, deal, semiring,
                                             mask_type):
    csr = PLANAR_FIXTURES["rmat"][0]()
    util_round_csr_matrix_dim(csr, 1024, 1024)
    mod = SpMVModule(tg.EngineConfig(engine=engine, planar_deal=deal,
                                     device="cpu"))
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(csr)
    assert mod.engine_name == engine
    mod.engine.fused = False
    x, mask = _vectors(mod.engine)
    y = mod.apply(torch.from_numpy(x), torch.from_numpy(mask))
    assert mod.engine.launches["scatter"] == 0    # the plain versions ran
    _assert_matches(y, *_references(csr, semiring, x, mask, mask_type),
                    semiring)


def _empty_csr(n=2048):
    e = np.zeros(0, np.int64)
    return csr_from_coo(e, e, np.zeros(0, np.float32), n, n)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("deal", ["roll", "free", "bucket", "permc"])
def test_empty_matrix(deal, semiring):
    csr = _empty_csr()
    if deal == "roll":
        eng = RouterSpMV(pack_router(csr), tg.SEMIRINGS[semiring], CPU)
    elif deal == "permc":
        eng = PlanarSpMV(pack_permc(csr), tg.SEMIRINGS[semiring], CPU)
    else:
        eng = PlanarSpMV(pack_planar(csr, deal=deal),
                         tg.SEMIRINGS[semiring], CPU)
    assert eng.groups.groups.shape == (0, 4)
    assert eng.groups.order.numel() == 0 and eng.groups.nbytes() == 0
    eng.fused = False
    x = np.random.default_rng(1).random(csr.num_cols).astype(np.float32)
    y = eng(torch.from_numpy(x))
    want = np.asarray(jops.spmv_coo(
        jops.coo_from_csr(to_jax(csr)), jnp.asarray(x),
        jg.SEMIRINGS[semiring], None, jg.MaskType.NO_MASK))
    np.testing.assert_array_equal(y.numpy(), want)
    assert not y.any()


@pytest.mark.parametrize("deal", ["roll", "free", "permc"])
def test_foreign_arrays_raise(deal):
    """K3 and K11 read the table derived from the engine's own arrays."""
    name = "rmat"
    eng = _engine(deal, name, "arithmetic")
    other = (RouterSpMV if deal == "roll" else PlanarSpMV)(
        _layout(deal, name), tg.ArithmeticSemiring, CPU)
    s = eng.scatter(torch.ones(eng.num_cols))
    with pytest.raises(ValueError, match="own arrays"):
        eng.reduce(s, other.arrays)
    np.testing.assert_array_equal(eng.reduce(s, eng.arrays).numpy(),
                                  eng.reduce(s).numpy())
