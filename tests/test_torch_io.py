"""The port's numpy host layer against the JAX package's.

Same seeds must give the same graphs, the formatter utilities must agree,
and the port's `pack_router` must build every array of the JAX
`pack_router` (its numpy path) bit for bit. The deposit targets, which
only the port builds, must point every deposit at the first flush of its
own slot after it in stream order.
"""
import numpy as np
import pytest

import graphlily_tpu.io as jio
from graphlily_tpu.io import formatter as jfmt
from graphlily_tpu.io.matrix import CSRMatrix as JCSRMatrix
from graphlily_tpu.io.router_format import pack_router as jax_pack_router
from graphlily_tpu.io.planar_format import (
    pack_planar as jax_pack_planar, planes_to_triples as jax_planes_to_triples)

import graphlily_tpu_torch.io as tio
from graphlily_tpu_torch.io import (deposit_targets, pack_router, pack_planar,
                                    planes_to_triples)

from test_torch_fixtures import FIXTURES, PLANAR_FIXTURES

CSR_FIELDS = ("adj_data", "adj_indices", "adj_indptr")
LAYOUT_ARRAYS = ("a_r", "a_sub", "a_vals", "a_page", "rg", "c_code", "c_hi",
                 "c_lo", "el_slot")
LAYOUT_SCALARS = ("num_rows", "num_cols", "nnz", "num_col_tiles",
                  "num_regions", "region_rows", "cb", "rstep", "f", "nsteps",
                  "fill_a", "fill_stream", "dstep", "num_slots")
PLANAR_ARRAYS = ("a_r", "xperm", "a_vals", "a_page", "rg", "planes", "c_code",
                 "c_hi", "c_lo", "el_slot", "el_stream", "a_sub")
PLANAR_SCALARS = LAYOUT_SCALARS + ("dmax",)
DEALS = ["free", "bucket"]


def to_jax(csr) -> JCSRMatrix:
    return JCSRMatrix(csr.num_rows, csr.num_cols, csr.adj_data.copy(),
                      csr.adj_indices.copy(), csr.adj_indptr.copy())


def assert_same_csr(a, b):
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    for field in CSR_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("name,args", [
    ("rmat_csr", (3000, 40000, 5)),
    ("rmat_csr", (20000, 120000, 9)),
    ("uniform_csr", (1500, 1500, 4, 21)),
    ("uniform_csr", (900, 2100, 3, 6)),
    ("dense_csr", (256, 256)),
    ("conflict_csr", (1024, 2048)),
])
def test_generators_match(name, args):
    assert_same_csr(getattr(tio, name)(*args), getattr(jio, name)(*args))


def test_iccad_standin_matches():
    assert tio.ICCAD_GRAPHS == jio.ICCAD_GRAPHS
    assert_same_csr(tio.iccad_standin("googleplus", scale=0.01, seed=3),
                    jio.iccad_standin("googleplus", scale=0.01, seed=3))


def test_formatter_utilities_match():
    g = tio.rmat_csr(3000, 40000, seed=5)
    jg = to_jax(g)
    perm = tio.degree_sort_permutation(g)
    np.testing.assert_array_equal(perm, jfmt.degree_sort_permutation(jg))
    assert_same_csr(tio.symmetric_permute(g, perm),
                    jfmt.symmetric_permute(jg, perm))
    assert_same_csr(tio.permute_rows(g, perm[::-1].copy()),
                    jfmt.permute_rows(jg, perm[::-1].copy()))
    a, b = g.copy(), jg.copy()
    tio.util_round_csr_matrix_dim(a, 1024, 1024)
    jfmt.util_round_csr_matrix_dim(b, 1024, 1024)
    assert_same_csr(a, b)
    tio.util_normalize_csr_matrix_by_outdegree(a)
    jfmt.util_normalize_csr_matrix_by_outdegree(b)
    assert_same_csr(a, b)
    assert tio.estimate_chunk_layout_gb(g) == jfmt.estimate_chunk_layout_gb(jg)
    c, jc = tio.csr2csc(g), jio.csr2csc(jg)
    assert_same_csr(c, jc)


def test_npz_loader_matches(tmp_path):
    g = tio.uniform_csr(900, 2100, 3, seed=6)
    path = tmp_path / "g.npz"
    jio.save_csr_matrix_to_float_npz(to_jax(g), path)
    assert_same_csr(tio.load_csr_matrix_from_float_npz(path),
                    jio.load_csr_matrix_from_float_npz(path))


def _pack_both(name):
    build, region_rows = FIXTURES[name]
    csr = build()
    return (pack_router(csr, region_rows=region_rows),
            jax_pack_router(to_jax(csr), region_rows=region_rows,
                            native=False))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_router_matches_jax(name):
    lay, jlay = _pack_both(name)
    for field in LAYOUT_ARRAYS:
        a, b = getattr(lay, field), getattr(jlay, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in LAYOUT_SCALARS:
        assert getattr(lay, field) == getattr(jlay, field), field
    assert lay.mem_bytes == jlay.mem_bytes


def _pack_planar_both(name, deal, keep_el_stream=False):
    build, region_rows = PLANAR_FIXTURES[name]
    csr = build()
    return (pack_planar(csr, region_rows=region_rows, deal=deal,
                        keep_el_stream=keep_el_stream),
            jax_pack_planar(to_jax(csr), region_rows=region_rows, deal=deal,
                            keep_el_stream=keep_el_stream, native=False))


@pytest.mark.parametrize("keep_el_stream", [False, True],
                         ids=["plain", "el_stream"])
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_pack_planar_matches_jax(name, deal, keep_el_stream):
    lay, jlay = _pack_planar_both(name, deal, keep_el_stream)
    if region_rows := PLANAR_FIXTURES[name][1]:
        assert lay.region_rows == region_rows
    assert (lay.a_sub is not None) == (deal == "free")
    assert (lay.el_stream is not None) == keep_el_stream
    for field in PLANAR_ARRAYS:
        a, b = getattr(lay, field), getattr(jlay, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in PLANAR_SCALARS:
        assert getattr(lay, field) == getattr(jlay, field), field
    assert lay.mem_bytes == jlay.mem_bytes


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_planes_to_triples_matches_jax(name, deal):
    """The blocked conversion gives JAX's words, whatever the block."""
    lay, jlay = _pack_planar_both(name, deal)
    want = jax_planes_to_triples(jlay)
    for block_steps in (1, 3, 64):
        got = planes_to_triples(lay, block_steps=block_steps)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_planes_to_triples_rejects_broken_run():
    lay, _ = _pack_planar_both("rmat", "free")
    t, p, s = np.argwhere((lay.planes < 0).sum(axis=3) >= 3)[0]
    lane = np.nonzero(lay.planes[t, p, s] < 0)[0][0]
    lay.planes[t, p, s, lane + 1] = 0      # a hole inside the run
    with pytest.raises(ValueError, match="single run"):
        planes_to_triples(lay)


def _check_deposit_targets(lay):
    rg = lay.rg.astype(np.int64)
    target = deposit_targets(lay.rg, lay.dstep, lay.f)
    assert target.shape == (lay.nsteps, lay.dstep)
    w2 = rg[..., 1]
    # every flush: stream chunk -> (step, slot, stream position)
    ft, fj = np.nonzero(w2[:, lay.dstep:] < 0)
    fw = w2[ft, fj + lay.dstep]
    chunk = ft * lay.f + ((fw >> 16) & 0xFF)
    flush_slot = dict(zip(chunk.tolist(), (fw & 0xFFF).tolist()))
    flush_pos = dict(zip(chunk.tolist(), (ft * lay.rstep + fj + lay.dstep)
                         .tolist()))
    slot_flushes = {}
    for c, s in flush_slot.items():
        slot_flushes.setdefault(s, []).append(flush_pos[c])
    dt, dj = np.nonzero(w2[:, :lay.dstep] > 0)
    assert np.all(target[w2[:, :lay.dstep] <= 0] == -1)
    for t, j in zip(dt.tolist(), dj.tolist()):
        tgt = int(target[t, j])
        slot = int(w2[t, j] & 0xFFF)
        pos = t * lay.rstep + j
        assert flush_slot[tgt] == slot
        assert flush_pos[tgt] > pos
        assert flush_pos[tgt] == min(p for p in slot_flushes[slot] if p > pos)
        assert lay.c_code[tgt] >= 0


@pytest.mark.parametrize("name", ["uniform", "rmat", "multi_region",
                                  "hub_page", "region_1024"])
def test_deposit_targets_hit_first_later_flush_of_own_slot(name):
    _check_deposit_targets(_pack_both(name)[0])


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_planar_deposit_targets_hit_first_later_flush_of_own_slot(name, deal):
    """The planar descriptor words share the roll layout's slot and flush
    fields, so `deposit_targets` applies unchanged."""
    _check_deposit_targets(_pack_planar_both(name, deal)[0])


def test_deposit_targets_reject_unflushed_deposit():
    lay, _ = _pack_both("uniform")
    rg = lay.rg.copy()
    rg[:, lay.dstep:, :] = 0          # drop every flush
    with pytest.raises(ValueError, match="no later flush"):
        deposit_targets(rg, lay.dstep, lay.f)
