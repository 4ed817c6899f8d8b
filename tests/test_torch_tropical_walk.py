"""The tropical engine's walk, on the CPU, and the empty-matrix case of the
roll and planar engines.

The walk (`TropicalSpMV.fused`, K1's kernel in ADDMIN mode on the card)
computes the SpMV's int32 encodings `out` in one pass over the pass-1
engine's row form, and `fused_predicated` over its tile form. Their plain
version (`fused_plain`, what the engine runs on CPU tensors) is checked
here:

  * bit-equal to the three-pass plain versions of `TropicalStages`,
    window_reduce(split(scatter(x))), on the tropical fixtures, both split
    formats and the "free" and "bucket" deals, on x >= 0 and on negative
    x (ROADMAP queue 3 F2: the reference's wrong minima, which the port
    keeps equal to JAX's; `pack_tropical` refuses negative stored values,
    and a graph whose negative weights the caller clipped to 0 keeps the
    equality). The walk's out spans the pass-1
    regions' rows: K10's out is its prefix, and the rows past it hold 0;
  * predicated at empty, one-vertex and 5% frontiers, bit-equal to the
    unpredicated walk;
  * through `__call__` and `call_predicated`, bit-equal to JAX `spmv_coo`
    and the float64 oracle rounded to float32 on x >= 0 (JAX's
    interpret-mode TropicalSpMV stays in the slow tier,
    test_torch_tropical.py; the three-pass equality above links the walk
    to it);
  * SSSP pull, push and pull_push on the tropical engine equal JAX's apps
    and the oracle, and no app path builds the three-pass stages: no split
    schedule, no K8 form, no pass-1 store form.

The empty matrix (ROADMAP queue 3 F1): a 2048 x 2048 CSR with no entry
gives y = 0 on "roll" and the three planar deals, through SpMVModule and
SpMSpVModule, for MULADD and ANDOR under every mask type, as JAX's
engines do (interpret mode); ADDMIN raises "empty layout" as JAX's
tropical engine does.
"""
import functools

import numpy as np
import pytest
import torch

import graphlily_tpu as jg
from graphlily_tpu import ops as jops
from graphlily_tpu.apps import SSSP as JaxSSSP
from graphlily_tpu.io import matrix as jmatrix
from graphlily_tpu.module import SpMVModule as JaxSpMVModule

import graphlily_tpu_torch as tg
from graphlily_tpu_torch.apps import SSSP
from graphlily_tpu_torch.io import (csr_from_coo, csr2csc, pack_tropical,
                                    rmat_csr)
from graphlily_tpu_torch.io import tropical_format
from graphlily_tpu_torch.module import SpMVModule, SpMSpVModule
from graphlily_tpu_torch.ops import TropicalStages, sparse_from_entries
from graphlily_tpu_torch.ops import tropical

from test_torch_fixtures import TROPICAL_FIXTURES, one_thread
from test_torch_io import to_jax
from test_torch_tropical import (CPU, DEALS, FORMATS, INF, _assert_bits,
                                 _engine, _references, _stages, _x)

FRONTIERS = ["empty", "one", "5pct"]


def _three_pass(stages, x):
    """K10's out through the three-pass plain versions."""
    return stages.window_reduce(stages.split(stages.scatter(x)))


def _assert_walk_is_three_pass(stages, out, three):
    """The walk's out holds K10's as its prefix, and 0 past it."""
    assert (out.dtype == torch.int32
            and out.numel() == stages.walk.planar.out_len)
    n = stages.num_windows * 128
    assert three.numel() == n <= out.numel()
    assert torch.equal(out[:n], three)
    assert not out[n:].any()


def _negative_x(n, seed=5):
    """_x with a third of its entries negated, and three far below
    -FLOAT_INF (their encodings wrap past int32)."""
    rng = np.random.default_rng(seed)
    x = _x(n, seed)
    x[rng.random(n) < 0.3] *= -1
    x[:3] = -3e9
    return x


@pytest.mark.parametrize("sign", ["nonneg", "negative_x"])
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_walk_plain_equals_three_pass_plain(name, fmt, deal, sign):
    _, stages = _stages(name, fmt, deal)
    eng = stages.walk
    x = torch.from_numpy(_x(eng.num_cols) if sign == "nonneg"
                         else _negative_x(eng.num_cols))
    out = eng.fused(x)
    _assert_walk_is_three_pass(stages, out, _three_pass(stages, x))
    assert torch.equal(out, eng.fused_plain(x))
    assert stages.launches == dict.fromkeys(stages.launches, 0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_walk_on_negative_stored_values(fmt):
    """F2's input: a graph with negative weights and a negative x. The pack
    refuses the negative weights; clipped to 0 by the caller, as the pack
    once did itself, they give a graph on which the walk keeps the three
    passes' wrong minima on a negative x bit for bit."""
    g = rmat_csr(3000, 20000, seed=3)
    g.adj_data[:g.nnz:4] *= -1
    with pytest.raises(ValueError, match="stored values >= 0"):
        pack_tropical(g, tg.EngineConfig(), split_format=fmt)
    g.adj_data[:g.nnz] = np.maximum(g.adj_data[:g.nnz], 0)
    stages = TropicalStages(
        pack_tropical(g, tg.EngineConfig(), split_format=fmt), CPU)
    x = torch.from_numpy(_negative_x(stages.walk.num_cols))
    _assert_walk_is_three_pass(stages, stages.walk.fused(x),
                               _three_pass(stages, x))


def _frontier(n, kind, seed=8):
    """A frontier x: FLOAT_INF off it; "one" holds a source at distance 0
    in column tile 1, "5pct" 5% of the columns at distances up to 10."""
    x = np.full(n, INF, np.float32)
    rng = np.random.default_rng(seed)
    if kind == "one":
        x[1024 + 7] = 0.0
    elif kind == "5pct":
        on = rng.random(n) < 0.05
        x[on] = (rng.random(int(on.sum())) * 10).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_predicated_walk_equals_unpredicated(name, fmt, kind):
    csr, stages = _stages(name, fmt)
    eng = stages.walk
    x = _frontier(eng.num_cols, kind)
    xt = torch.from_numpy(x)
    act = eng.activity(xt)
    assert int(act.sum()) == {"empty": 0, "one": 1}.get(
        kind, int(act.numel()))
    out = eng.fused_predicated(xt, act)
    assert torch.equal(out, eng.fused(xt))
    assert torch.equal(out, eng.fused_plain(xt, act))
    _assert_walk_is_three_pass(stages, out, _three_pass(stages, xt))
    y = eng.call_predicated(xt)
    _assert_bits(y.numpy(), eng(xt).numpy(), *_references(csr, x))


@pytest.mark.parametrize("mask_type", list(tg.MaskType),
                         ids=lambda m: m.name)
@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_walk_calls_bit_equal_to_references(fmt, deal, mask_type):
    """`__call__` and `call_predicated` (a frontier of a third of the
    tiles) on the multi-region graph, under each mask type."""
    csr, eng = _engine("multi_region", fmt, deal, mask_type)
    x = _x(eng.num_cols)
    mask = (np.random.default_rng(4).random(eng.num_rows) < 0.5).astype(
        np.float32)
    mt = None if mask_type == tg.MaskType.NO_MASK else torch.from_numpy(mask)
    want = _references(csr, x, None if mt is None else mask, mask_type)
    _assert_bits(eng(torch.from_numpy(x), mt).numpy(), *want)
    xf = x.copy()
    xf[(np.arange(eng.num_cols) // 1024) % 3 != 0] = INF
    want = _references(csr, xf, None if mt is None else mask, mask_type)
    _assert_bits(eng.call_predicated(torch.from_numpy(xf), mt).numpy(),
                 *want)


@pytest.mark.parametrize("deal", DEALS)
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_sssp_runs_the_walk_only(sort, deal, monkeypatch):
    """SSSP pull, push and pull_push on the tropical engine equal the JAX
    app and the float64 oracle, with the three passes' set-up made to
    raise: building the app packs no split schedule and derives no K8
    form and no pass-1 store form."""
    def refuse(*args, **kwargs):
        raise AssertionError("an app path built a three-pass stage")

    for fn in ("build_split_schedule", "derive_split_triples",
               "compact_window_stream"):
        monkeypatch.setattr(tropical_format, fn, refuse)
    monkeypatch.setattr(tropical, "split_pieces", refuse)
    g = rmat_csr(12000, 60000, seed=11)
    app = SSSP(tg.EngineConfig(engine="router", sort_rows_by_degree=sort,
                               planar_deal=deal, device="cpu"))
    app.load_and_format_matrix(g)
    assert app.SpMV_.engine_name == "tropical"
    assert app.SpMSpV_.engine is app.SpMV_.engine
    assert not hasattr(app.SpMV_.engine.planar, "store_entries")
    jax_app = JaxSSSP(jg.EngineConfig(engine="xla"))
    jax_app.load_and_format_matrix(to_jax(g))
    want = app.compute_reference_results(0, 6)
    runs = {"pull": (app.pull(0, 6), jax_app.pull(0, 6)),
            "push": (app.push(0, 6), jax_app.push(0, 6)),
            "pull_push": (app.pull_push(0, 6, 0.05),
                          jax_app.pull_push(0, 6, 0.05))}
    for label, (got, jax_got) in runs.items():
        np.testing.assert_array_equal(got, np.asarray(jax_got),
                                      err_msg=label)
        np.testing.assert_array_equal(got, want, err_msg=label)
    assert 1 < (want < INF).sum() < g.num_rows


# ---- F1: the empty matrix --------------------------------------------------
EMPTY_N = 2048
EMPTY_ENGINES = [("roll", "free"), ("planar", "free"), ("planar", "bucket"),
                 ("planar", "permc")]


def _empty_csr():
    e = np.zeros(0, np.int64)
    return csr_from_coo(e, e, np.zeros(0, np.float32), EMPTY_N, EMPTY_N)


@functools.cache
def _jax_empty(engine, deal, semiring):
    """JAX's engine (interpret mode) on the empty matrix, formatted once."""
    mod = JaxSpMVModule(jg.EngineConfig(engine=engine, planar_deal=deal,
                                        interpret=True))
    mod.set_semiring(jg.SEMIRINGS[semiring])
    mod.load_and_format_matrix(to_jax(_empty_csr()))
    return mod


@pytest.mark.parametrize("mask_type", list(tg.MaskType),
                         ids=lambda m: m.name)
@pytest.mark.parametrize("semiring", ["arithmetic", "logical"])
@pytest.mark.parametrize("engine,deal", EMPTY_ENGINES,
                         ids=["roll", "free", "bucket", "permc"])
def test_empty_matrix_gives_zeros(engine, deal, semiring, mask_type):
    """SpMV through SpMVModule and SpMSpV through SpMSpVModule sharing its
    engine: y = 0, as JAX's engine and spmspv_coo give."""
    cfg = tg.EngineConfig(engine=engine, planar_deal=deal, device="cpu")
    mod = SpMVModule(cfg)
    mod.set_semiring(tg.SEMIRINGS[semiring])
    mod.set_mask_type(mask_type)
    mod.load_and_format_matrix(_empty_csr())
    assert mod.engine_name == engine
    x = np.random.default_rng(1).random(EMPTY_N).astype(np.float32)
    mask = (np.arange(EMPTY_N) % 2).astype(np.float32)
    y = mod.apply(torch.from_numpy(x), torch.from_numpy(mask))
    jmod = _jax_empty(engine, deal, semiring)
    jmod.set_mask_type(jg.MaskType(mask_type))
    want = np.asarray(jmod.apply(x, mask))
    np.testing.assert_array_equal(y.numpy(), want)
    assert not want.any()

    spmspv = SpMSpVModule(cfg)
    spmspv.set_semiring(tg.SEMIRINGS[semiring])
    spmspv.set_mask_type(mask_type)
    spmspv.load_and_format_matrix(csr2csc(_empty_csr()), reuse_from=mod)
    assert spmspv.engine is mod.engine
    idx = np.array([3, 1500])
    vals = np.array([1.0, 2.5], np.float32)
    sv, y = spmspv.apply(sparse_from_entries(idx, vals, spmspv.capacity),
                         torch.from_numpy(mask))
    _, want = jops.spmspv_coo(
        jops.coo_from_csc(jmatrix.csr2csc(to_jax(_empty_csr()))),
        jops.sparse_from_entries(idx, vals, capacity=spmspv.capacity),
        jg.SEMIRINGS[semiring], np.asarray(mask), jg.MaskType(mask_type))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    assert not y.any() and int(sv.nnz) == 0


def test_empty_matrix_tropical_raises_as_jax():
    """The tropical engine refuses an empty layout, as JAX's does."""
    mod = SpMVModule(tg.EngineConfig(engine="router", device="cpu"))
    mod.set_semiring(tg.TropicalSemiring)
    with pytest.raises(AssertionError, match="empty layout"):
        mod.load_and_format_matrix(_empty_csr())
    jmod = JaxSpMVModule(jg.EngineConfig(engine="router", interpret=True))
    jmod.set_semiring(jg.TropicalSemiring)
    with pytest.raises(AssertionError, match="empty layout"):
        jmod.load_and_format_matrix(to_jax(_empty_csr()))
