"""The port's chunked engine on the CPU (the plain PyTorch version of the
K6/K7 kernel) and its layout, against the JAX package.

`pack_csr_chunks` must build every array of the JAX function's numpy path
(its native packer is switched off here: on CSR rows whose columns are not
sorted it orders equal-row lanes by input position instead of column,
ROADMAP queue 3) for both pad values and both chunk orders.
`ChunkedSpMV` is held to JAX `spmv_coo` on the padded graph and to the
float64 oracle: logical results bit-equal to both, tropical bit-equal to
`spmv_coo` and within one fp32 rounding of the oracle (which adds x + val
in fp64), arithmetic within max|y - ref| <= 1e-5 * max|ref| (the plain
version sums in another order than both references). Tropical x is >= 0,
the engine's contract. One slow case holds the engine against JAX
`PallasSpMV` in Pallas interpret mode, streamed (K6) and resident (K7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlily_tpu as jg
import graphlily_tpu.native as jnative
from graphlily_tpu.io import formatter as jfmt
from graphlily_tpu.ops.spmv_pallas import PallasSpMV as JaxPallasSpMV

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.io import (pack_csr_chunks, add_self_edges_for_sssp,
                                    rmat_csr, uniform_csr)
from graphlily_tpu_torch.io.matrix import csr_from_coo
from graphlily_tpu_torch.ops import ChunkedSpMV

from test_torch_fixtures import CHUNKED_FIXTURES
from test_torch_io import assert_same_csr, to_jax
from test_torch_router import CPU, MASKS, _references

SEMIRINGS = ["arithmetic", "logical", "tropical"]
INF = float(tg.FLOAT_INF)
LAYOUT_ARRAYS = ("r", "rows", "vals", "code", "inv", "el_slot", "step_touch")
LAYOUT_SCALARS = ("num_rows", "num_cols", "nnz", "num_col_tiles",
                  "num_window_groups", "row_window", "col_tile", "fill",
                  "num_chunks")


@pytest.fixture
def jax_numpy_pack(monkeypatch):
    """JAX's pack_csr_chunks on its numpy path."""
    monkeypatch.setattr(jnative, "pack_assign", lambda *a, **k: None)
    return jfmt.pack_csr_chunks


def _pack(fixture, semiring, chunk_order="row"):
    csr = CHUNKED_FIXTURES[fixture]()
    return csr, pack_csr_chunks(csr, pad_val=tg.SEMIRINGS[semiring].zero,
                                chunk_order=chunk_order)


def _vectors(lay, semiring, seed=12345):
    rng = np.random.default_rng(seed)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = tg.SEMIRINGS[semiring].zero
    mask = (rng.random(lay.num_rows) < 0.5).astype(np.float32)
    return x, mask


def _assert_matches(y, want, want64, name):
    y = np.asarray(y)
    if name == "arithmetic":
        for ref in (want.astype(np.float64), want64):
            assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
    elif name == "logical":
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(y.astype(np.float64), want64)
    else:
        # min is exact; x + val rounds once in fp32 (the oracle adds in fp64)
        np.testing.assert_array_equal(y, want)
        np.testing.assert_allclose(y, want64, rtol=2.0**-23, atol=0)


def _run(fixture, name, mask_type, chunk_order="row"):
    csr, lay = _pack(fixture, name, chunk_order)
    eng = ChunkedSpMV(lay, tg.SEMIRINGS[name], CPU, mask_type)
    x, mask = _vectors(lay, name)
    y = eng(torch.from_numpy(x), torch.from_numpy(mask))
    assert eng.launches == {"chunked": 0}
    assert y.shape == (lay.num_rows,) and y.dtype == torch.float32
    return csr, y.numpy(), x, mask


# ---- layout ------------------------------------------------------------------
@pytest.mark.parametrize("chunk_order", ["row", "col"])
@pytest.mark.parametrize("pad_val", [0.0, INF], ids=["zero", "inf"])
@pytest.mark.parametrize("fixture", ["uniform", "rmat", "conflict",
                                     "hub_rows", "empty_windows"])
def test_pack_csr_chunks_matches_jax(fixture, pad_val, chunk_order,
                                     jax_numpy_pack):
    csr = CHUNKED_FIXTURES[fixture]()
    lay = pack_csr_chunks(csr, pad_val=pad_val, chunk_order=chunk_order)
    jlay = jax_numpy_pack(to_jax(csr), pad_val=pad_val,
                          chunk_order=chunk_order)
    assert (lay.inv is not None) == (pad_val != 0)
    assert (lay.step_touch is not None) == (chunk_order == "col")
    for field in LAYOUT_ARRAYS:
        a, b = getattr(lay, field), getattr(jlay, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in LAYOUT_SCALARS:
        assert getattr(lay, field) == getattr(jlay, field), field
    assert lay.num_chunks % 64 == 0


def _with_diagonal():
    """RMAT plus explicit diagonal entries of weight 3 on every third row
    (add_self_edges_for_sssp zeroes them and inserts the rest)."""
    g = rmat_csr(2000, 15000, seed=4)
    d = np.arange(0, 2000, 3, dtype=np.int64)
    return csr_from_coo(np.concatenate([g.row_ids(), d]),
                        np.concatenate([g.adj_indices[:g.nnz], d]),
                        np.concatenate([g.adj_data[:g.nnz],
                                        np.full(len(d), 3, np.float32)]),
                        2000, 2000)


@pytest.mark.parametrize("build", [lambda: rmat_csr(3000, 40000, seed=5),
                                   lambda: uniform_csr(900, 2100, 3, seed=6),
                                   _with_diagonal],
                         ids=["rmat", "rect", "diagonal"])
def test_add_self_edges_for_sssp_matches_jax(build):
    csr = build()
    got = add_self_edges_for_sssp(csr)
    assert_same_csr(got, jfmt.add_self_edges_for_sssp(to_jax(csr)))
    rows = got.row_ids()
    diag = rows == got.adj_indices[:got.nnz]
    assert len(np.unique(rows[diag])) == min(csr.num_rows, csr.num_cols)
    assert not got.adj_data[:got.nnz][diag].any()


@pytest.mark.parametrize("fixture", list(CHUNKED_FIXTURES))
def test_every_nnz_lands_at_its_el_slot(fixture):
    """The plain version's (col, row) of each nnz's slot is the nnz's own,
    and its value is the nnz's value."""
    csr, lay = _pack(fixture, "arithmetic")
    eng = ChunkedSpMV(lay, tg.ArithmeticSemiring, CPU)
    col, row = (t.numpy() for t in eng.plain_index())
    nnz = csr.nnz
    np.testing.assert_array_equal(col[lay.el_slot],
                                  csr.adj_indices[:nnz].astype(np.int64))
    np.testing.assert_array_equal(row[lay.el_slot], csr.row_ids())
    np.testing.assert_array_equal(lay.vals.reshape(-1)[lay.el_slot],
                                  csr.adj_data[:nnz])
    assert len(np.unique(lay.el_slot)) == nnz


# ---- engine ------------------------------------------------------------------
@pytest.mark.parametrize("mask_type", MASKS, ids=lambda m: m.name)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_chunked_semirings_masks(name, mask_type):
    csr, y, x, mask = _run("uniform", name, mask_type)
    _assert_matches(y, *_references(csr, name, x, mask, mask_type), name)


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("fixture", [k for k in CHUNKED_FIXTURES
                                     if k != "uniform"])
def test_chunked_fixtures(fixture, name):
    csr, y, x, mask = _run(fixture, name, tg.MaskType.NO_MASK)
    _assert_matches(y, *_references(csr, name, x, mask,
                                     tg.MaskType.NO_MASK), name)
    if fixture == "empty_windows":
        assert (y[1024:] == (INF if name == "tropical" else 0)).all()
    if fixture == "tropical_empty_rows" and name == "tropical":
        assert (y[64:] == INF).all()


@pytest.mark.parametrize("name", SEMIRINGS)
def test_col_chunk_order_gives_the_same_y(name):
    """The engine accepts both chunk orders (the "col" order is SpMSpV's);
    logical and tropical y are bit-equal, arithmetic y differs only in
    the summation order."""
    _, y_row, _, _ = _run("rmat", name, tg.MaskType.NO_MASK, "row")
    _, y_col, _, _ = _run("rmat", name, tg.MaskType.NO_MASK, "col")
    if name == "arithmetic":
        assert np.abs(y_row - y_col).max() <= 1e-6 * np.abs(y_row).max()
    else:
        np.testing.assert_array_equal(y_row, y_col)


def test_engine_takes_jax_layout(jax_numpy_pack):
    """A JAX package layout (plain numpy) drives the port's engine and
    gives the same result as the port's own layout."""
    csr = CHUNKED_FIXTURES["rmat"]()
    for name in SEMIRINGS:
        zero = tg.SEMIRINGS[name].zero
        lay = pack_csr_chunks(csr, pad_val=zero)
        jlay = jax_numpy_pack(to_jax(csr), pad_val=zero)
        x, _ = _vectors(lay, name)
        xt = torch.from_numpy(x)
        a = ChunkedSpMV(lay, tg.SEMIRINGS[name], CPU)(xt)
        b = ChunkedSpMV(jlay, tg.SEMIRINGS[name], CPU)(xt)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_check_arguments():
    _, lay = _pack("rmat", "arithmetic")
    eng = ChunkedSpMV(lay, tg.ArithmeticSemiring, CPU)
    with pytest.raises(ValueError, match="float32"):
        eng.spmv(torch.zeros(lay.num_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="elements"):
        eng.spmv(torch.zeros(lay.num_cols + 1))
    with pytest.raises(ValueError, match="pad value"):
        ChunkedSpMV(lay, tg.TropicalSemiring, CPU)
    with pytest.raises(ValueError, match="pad value"):
        ChunkedSpMV(_pack("rmat", "tropical")[1], tg.LogicalSemiring, CPU)
    with pytest.raises(NotImplementedError, match="item 8"):
        eng.call_predicated(torch.zeros(lay.num_cols), None, None)


@pytest.mark.slow
@pytest.mark.parametrize("resident", [False, True], ids=["K6", "K7"])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_matches_jax_pallas_interpret(name, resident):
    """The engine against JAX PallasSpMV in interpret mode: the streamed
    kernel (K6) and the resident one (K7), on the JAX resident test's
    graph."""
    csr = uniform_csr(1200, 1100, 4, seed=33)
    zero = tg.SEMIRINGS[name].zero
    lay = pack_csr_chunks(csr, pad_val=zero)
    x, mask = _vectors(lay, name)
    mt = tg.MaskType.WRITE_TO_ZERO
    cfg = jg.EngineConfig(interpret=True, resident_kernel=resident)
    jeng = JaxPallasSpMV(jfmt.pack_csr_chunks(to_jax(csr), cfg, pad_val=zero),
                         jg.SEMIRINGS[name], cfg, jg.MaskType(mt))
    assert jeng.resident == resident
    want = np.asarray(jeng(jnp.asarray(x), jnp.asarray(mask)))
    got = ChunkedSpMV(lay, tg.SEMIRINGS[name], CPU, mt)(
        torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want64 = _references(csr, name, x, mask, mt)[1]
    _assert_matches(got, want, want64, name)
