"""CUDA kernels K1 (fused), K2 (scatter), K3 (reduce) of the roll router,
K4 (scatter, fused) and K5 (xperm) of the planar router, the chunked
K6/K7 kernel, the tropical engine's K4 scatter in ADDMIN mode, K8 and K9
(split) and K10 (window reduce), K11 (the PERM-C run-sum reduce) and K4
fused on PERM-C layouts, and the frontier-predicated forms K1p, K2p,
K3p, K4p, K7p and K11p (SpMSpV, for empty, 1-vertex and 5% frontiers)
against their plain PyTorch versions and the unpredicated kernels, on the
card. The chunked kernel also runs on small block tables that stress its
shared tile (a hub window over many blocks, empty window groups), and K4
fused on PERM-C, "free" and "bucket" layouts of the hub-column graph. K1
and K1p run over their derived form in both orders and on block tables
that cut deposits; K8 over its compact form against a walk of the deposit
planes, on pieces longer than a warp's pass. K4 fused runs K1's kernel
over the planar engine's row-sorted form on all three deals, MULADD and
ANDOR (without and with the value stream), on a graph with an empty
region, an all-zero x, hub rows that cross block edges and regions cut
into several column windows. K4 scatter and K4p scatter run over the
planar engine's piece-ordered store form in all three semirings and
deals, also on blocks cut inside pieces and at a cap of three pieces a
block; K4p fused over its tile form at three frontiers against the
float64 oracle. K3 and K11 run over the region-group table at the
default group size, at one chunk a group (every split region reaches y
through vector reductions alone), in regions of 16,384 rows (a 64 KB
shared tile, above the default 48 KB) and on the empty matrix.

Needs a CUDA card and nvcc; every test skips without a card. Imports only
torch and the port (no jax), so on a machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: K2, K4 scatter and K5 are pure copies of products or of x and
must equal their plain versions bit for bit. K1, K4 fused, K3 and K11 add
with float atomics in an order that changes from run to run: ANDOR adds
0/1 counts and stays exact; MULADD is
held to max|y - y64| <= 1e-5 * max|y64| against the float64 oracle at
these sizes (the smoke test's googleplus bound is 1e-4, for hub rows of up
to ~1e5 terms). The chunked kernel: ANDOR and ADDMIN bit-equal to the
plain version, MULADD within 1e-4 * max|y64| (its atomics land in any
order; hub windows fold thousands of chunks into 128 rows). The tropical
kernels move or max int32 encodings and must equal their plain versions
bit for bit; the engine's y equals the float64 oracle rounded to float32
(rounding is monotone, so it commutes with the min).
"""
import numpy as np
import pytest
import torch

from graphlily_tpu_torch import (ArithmeticSemiring, LogicalSemiring,
                                 TropicalSemiring, EngineConfig)
from graphlily_tpu_torch.io import (rmat_csr, pack_router, pack_planar,
                                    pack_permc, pack_csr_chunks,
                                    pack_tropical, csr_from_coo,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule
from graphlily_tpu_torch.ops import (RouterSpMV, PlanarSpMV, ChunkedSpMV,
                                     TropicalStages)
from graphlily_tpu_torch.ops.chunked import chunk_entries
from graphlily_tpu_torch.ops.router import router_entries
from graphlily_tpu_torch.io.router_format import deposit_targets

from test_torch_fixtures import (FIXTURES, PLANAR_FIXTURES, CHUNKED_FIXTURES,
                                 TROPICAL_FIXTURES, hub_window_csr,
                                 stored_zeros_csr)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _oracle(csr, semiring, x):
    mod = SpMVModule(EngineConfig(engine="xla", device="cpu"))
    mod.set_semiring(semiring)
    padded = csr.copy()
    util_round_csr_matrix_dim(padded, 1024, 1024)
    mod.load_and_format_matrix(padded)
    return mod.compute_reference_results(x)


@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_kernels_match_plain(name, semiring, cuda):
    build, region_rows = FIXTURES[name]
    csr = build()
    lay = pack_router(csr, region_rows=region_rows)
    eng = RouterSpMV(lay, semiring, EngineConfig(device="cuda"))
    rng = np.random.default_rng(7)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = 0.0
    xt = torch.from_numpy(x).to(cuda)

    stream = eng.scatter(xt)
    stream_plain = eng.scatter_plain(xt)
    assert torch.equal(stream.view(torch.int32),
                       stream_plain.view(torch.int32))
    y_reduce = eng.reduce(stream)
    y_reduce_plain = eng.reduce_plain(stream)
    y_fused = eng.fused_spmv(xt)
    y_fused_plain = eng.fused_plain(xt)
    torch.cuda.synchronize()
    assert eng.launches == {"fused": 1, "scatter": 1, "reduce": 1,
                            "fused_pred": 0, "scatter_pred": 0,
                            "reduce_pred": 0}

    want = _oracle(csr, semiring, x)
    n = lay.num_rows
    outs = {"K3": y_reduce, "K3 plain": y_reduce_plain,
            "K1": y_fused, "K1 plain": y_fused_plain}
    for label, y in outs.items():
        y = y[:n].cpu().numpy().astype(np.float64)
        if semiring is LogicalSemiring:
            np.testing.assert_array_equal((y != 0).astype(np.float64), want,
                                          err_msg=label)
        else:
            err = np.abs(y - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (label, err)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_engine_call_on_card(fused, cuda):
    """The engine's public call on CUDA tensors launches the kernels of its
    branch, never the plain versions."""
    csr = rmat_csr(3000, 40000, seed=5)
    lay = pack_router(csr)
    eng = RouterSpMV(lay, LogicalSemiring, EngineConfig(device="cuda"))
    eng.fused = fused
    x = (np.random.default_rng(3).random(lay.num_cols) < 0.1).astype(
        np.float32)
    y = eng(torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(y, _oracle(csr, LogicalSemiring, x))
    want = ({"fused": 1, "scatter": 0, "reduce": 0} if fused
            else {"fused": 0, "scatter": 1, "reduce": 1})
    assert eng.launches == {**want, "fused_pred": 0, "scatter_pred": 0,
                            "reduce_pred": 0}


def _assert_close_to_oracle(outs, want, n, semiring):
    for label, y in outs.items():
        y = y[:n].cpu().numpy().astype(np.float64)
        if semiring is LogicalSemiring:
            np.testing.assert_array_equal((y != 0).astype(np.float64), want,
                                          err_msg=label)
        else:
            err = np.abs(y - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (label, err)


@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_planar_kernels_match_plain(name, semiring, deal, cuda):
    build, region_rows = PLANAR_FIXTURES[name]
    csr = build()
    lay = pack_planar(csr, region_rows=region_rows, deal=deal)
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    rng = np.random.default_rng(7)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = 0.0
    xt = torch.from_numpy(x).to(cuda)

    if deal == "bucket":
        assert torch.equal(eng.xperm(xt).view(torch.int32),
                           eng.xperm_plain(xt).view(torch.int32))
    stream = eng.scatter(xt)
    stream_plain = eng.scatter_plain(xt)
    assert torch.equal(stream.view(torch.int32),
                       stream_plain.view(torch.int32))
    assert torch.equal(stream.view(torch.int32),
                       eng.scatter_entries_plain(xt).view(torch.int32))
    y_reduce = eng.reduce(stream)
    y_fused = eng.fused_spmv(xt)
    y_fused_plain = eng.fused_plain(xt)
    torch.cuda.synchronize()
    # the xperm check only: K4 scatter and K4 fused read their forms,
    # whose columns index x
    xperms = 1 if deal == "bucket" else 0
    assert eng.launches == {"fused": 1, "scatter": 1, "reduce": 1,
                            "xperm": xperms, "fused_pred": 0,
                            "scatter_pred": 0, "reduce_pred": 0}
    _assert_close_to_oracle({"K4 scatter -> K3": y_reduce, "K4 fused": y_fused,
                             "K4 fused plain": y_fused_plain},
                            _oracle(csr, semiring, x), lay.num_rows, semiring)


@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_planar_engine_call_on_card(fused, deal, cuda):
    """The planar engine's public call on CUDA tensors launches the kernels
    of its branch (never K5: K4 fused and K4 scatter gather x through
    columns resolved at init), never the plain versions."""
    csr = rmat_csr(50000, 150000, seed=5)
    lay = pack_planar(csr, deal=deal)
    eng = PlanarSpMV(lay, LogicalSemiring, EngineConfig(device="cuda"))
    eng.fused = fused
    x = (np.random.default_rng(3).random(lay.num_cols) < 0.1).astype(
        np.float32)
    y = eng(torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(y, _oracle(csr, LogicalSemiring, x))
    want = ({"fused": 1, "scatter": 0, "reduce": 0} if fused
            else {"fused": 0, "scatter": 1, "reduce": 1})
    assert eng.launches == {**want, "xperm": 0, "fused_pred": 0,
                            "scatter_pred": 0, "reduce_pred": 0}


CHUNKED_SEMIRINGS = [ArithmeticSemiring, LogicalSemiring, TropicalSemiring]
CHUNKED_CASES = {**CHUNKED_FIXTURES, "hub_window": hub_window_csr}


def _chunked_x(lay, semiring, seed=7):
    """Tropical x is >= 0 (the engine's contract), with unreached INF
    entries; the others get zeros."""
    rng = np.random.default_rng(seed)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = semiring.zero
    return x


def _check_chunked(y, y_plain, want, n, semiring):
    y64 = y[:n].cpu().numpy().astype(np.float64)
    if semiring is ArithmeticSemiring:
        err = np.abs(y64 - want).max()
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert torch.equal(y.view(torch.int32), y_plain.view(torch.int32))
        if semiring is LogicalSemiring:
            np.testing.assert_array_equal((y64 != 0).astype(np.float64), want)
        else:
            np.testing.assert_allclose(y64, want, rtol=2.0**-23, atol=0)


@pytest.mark.parametrize("semiring", CHUNKED_SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_chunked_kernel_matches_plain(name, semiring, cuda):
    csr = CHUNKED_CASES[name]()
    lay = pack_csr_chunks(csr, pad_val=semiring.zero)
    eng = ChunkedSpMV(lay, semiring, EngineConfig(device="cuda"))
    x = _chunked_x(lay, semiring)
    xt = torch.from_numpy(x).to(cuda)
    y = eng.spmv(xt)
    y_plain = eng.spmv_plain(xt)
    torch.cuda.synchronize()
    assert eng.launches == {"chunked": 1, "chunked_pred": 0}
    if name == "hub_window":
        assert (lay.code // lay.num_col_tiles == 0).sum() >= 4096
    _check_chunked(y, y_plain, _oracle(csr, semiring, x), lay.num_rows,
                   semiring)


@pytest.mark.parametrize("semiring", CHUNKED_SEMIRINGS, ids=lambda s: s.name)
def test_chunked_kernel_row_and_col_order(semiring, cuda):
    """The kernel gives the same y for either chunk order: bit for bit for
    ANDOR and ADDMIN, within the MULADD tolerance otherwise."""
    csr = CHUNKED_FIXTURES["rmat"]()
    ys = []
    for order in ("row", "col"):
        lay = pack_csr_chunks(csr, pad_val=semiring.zero, chunk_order=order)
        eng = ChunkedSpMV(lay, semiring, EngineConfig(device="cuda"))
        ys.append(eng.spmv(torch.from_numpy(_chunked_x(lay, semiring)).to(
            cuda)))
    torch.cuda.synchronize()
    if semiring is ArithmeticSemiring:
        assert (ys[0] - ys[1]).abs().max() <= 1e-4 * ys[0].abs().max()
    else:
        assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


@pytest.mark.parametrize("semiring", CHUNKED_SEMIRINGS, ids=lambda s: s.name)
def test_chunked_engine_call_on_card(semiring, cuda):
    """The module's chunked engine on CUDA tensors launches the kernel,
    never the plain version."""
    csr = rmat_csr(3000, 40000, seed=5)
    mod = SpMVModule(EngineConfig(engine="pallas", device="cuda"))
    mod.set_semiring(semiring)
    mod.load_and_format_matrix(csr)
    assert mod.engine_name == "chunked"
    x = _chunked_x(mod.engine, semiring, seed=3)
    y = mod.apply(torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert mod.engine.launches == {"chunked": 1, "chunked_pred": 0}
    want = _oracle(csr, semiring, x)
    if semiring is ArithmeticSemiring:
        assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()
    elif semiring is LogicalSemiring:
        np.testing.assert_array_equal(y, want)
    else:
        np.testing.assert_allclose(y, want, rtol=2.0**-23, atol=0)


# ---- frontier-predicated kernels (SpMSpV) ------------------------------------
FRONTIERS = ["empty", "one", "5pct"]


def _frontier(ncols, kind, zero, seed=11):
    """A dense frontier: no entry, one column, or 5% of the columns active
    (values >= 0.5), the semiring zero elsewhere."""
    rng = np.random.default_rng(seed)
    k = {"empty": 0, "one": 1, "5pct": ncols // 20}[kind]
    x = np.full(ncols, zero, np.float32)
    x[rng.choice(ncols, size=k, replace=False)] = (
        rng.random(k).astype(np.float32) + 0.5)
    return x


def _check_predicated(y, y_plain, y_full, semiring, label):
    """ANDOR: bit-equal to the plain version and to the unpredicated
    kernel; MULADD: within 1e-5 of max|y| of both (atomic order)."""
    if semiring is LogicalSemiring:
        assert torch.equal(y.view(torch.int32), y_plain.view(torch.int32)), \
            label
        assert torch.equal(y.view(torch.int32), y_full.view(torch.int32)), \
            label
    else:
        scale = max(float(y_plain.abs().max()), 1e-30)
        for ref in (y_plain, y_full):
            assert float((y - ref).abs().max()) <= 1e-5 * scale, label


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["rmat", "multi_region", "hub_page"])
def test_router_predicated_kernels_match_plain(name, semiring, kind, cuda):
    """K1p, K2p and K3p against their plain versions and the unpredicated
    kernels on the same frontier; K2p's stream bit-equal to its plain
    version."""
    build, region_rows = FIXTURES[name]
    lay = pack_router(build(), region_rows=region_rows)
    eng = RouterSpMV(lay, semiring, EngineConfig(device="cuda"))
    xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
    act = eng.activity(xt)
    live = eng.live_chunks(act)
    s = eng.scatter_predicated(xt, act)
    assert torch.equal(s.view(torch.int32),
                       eng.scatter_plain(xt, None, act).view(torch.int32))
    y3 = eng.reduce_predicated(s, live)
    y1 = eng.fused_predicated(xt, act)
    full = eng.fused_spmv(xt)
    torch.cuda.synchronize()
    assert eng.launches == {"fused": 1, "scatter": 0, "reduce": 0,
                            "fused_pred": 1, "scatter_pred": 1,
                            "reduce_pred": 1}
    _check_predicated(y1, eng.fused_plain(xt, None, act), full, semiring, "K1p")
    _check_predicated(y3, eng.reduce_plain(s, None, live), full, semiring,
                      "K3p")
    if kind == "empty":
        assert not y1.any() and not y3.any() and not s.any()


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["rmat", "hub_columns"])
def test_planar_predicated_kernels_match_plain(name, semiring, deal, kind,
                                               cuda):
    """K4p fused and K4p scatter (-> K3p) against their plain versions and
    the unpredicated kernels; K4p's stream bit-equal to its plain
    version."""
    build, region_rows = PLANAR_FIXTURES[name]
    lay = pack_planar(build(), region_rows=region_rows, deal=deal)
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
    act = eng.activity(xt)
    live = eng.live_chunks(act)
    s = eng.scatter_predicated(xt, act)
    assert torch.equal(s.view(torch.int32),
                       eng.scatter_plain(xt, None, act).view(torch.int32))
    y3 = eng.reduce_predicated(s, live)
    y4 = eng.fused_predicated(xt, act)
    full = eng.fused_spmv(xt)
    torch.cuda.synchronize()
    # K4p scatter, K4p fused and K4 fused read their forms, whose columns
    # index x: no K5
    assert eng.launches == {"fused": 1, "scatter": 0, "reduce": 0,
                            "xperm": 0, "fused_pred": 1,
                            "scatter_pred": 1, "reduce_pred": 1}
    _check_predicated(y4, eng.fused_plain(xt, None, act), full, semiring,
                      "K4p fused")
    _check_predicated(y3, eng.reduce_plain(s, None, live), full, semiring,
                      "K4p scatter -> K3p")


PERMC_LAUNCHES = {"fused": 0, "scatter": 0, "reduce": 0, "xperm": 0,
                  "fused_pred": 0, "scatter_pred": 0, "reduce_pred": 0,
                  "permc_reduce": 0, "permc_reduce_pred": 0}


@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(PLANAR_FIXTURES))
def test_permc_kernels_match_plain(name, semiring, cuda):
    """On PERM-C layouts: K4 scatter's stream bit-equal to its plain
    version; K11 on it, K4 fused and the engine call, fused and split,
    against the plain versions and the float64 oracle."""
    build, region_rows = PLANAR_FIXTURES[name]
    csr = build()
    lay = pack_permc(csr, region_rows=region_rows)
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    assert eng.permc
    rng = np.random.default_rng(7)
    x = rng.random(lay.num_cols).astype(np.float32) + 0.5
    x[rng.random(lay.num_cols) < 0.3] = 0.0
    xt = torch.from_numpy(x).to(cuda)
    stream = eng.scatter(xt)
    assert torch.equal(stream.view(torch.int32),
                       eng.scatter_plain(xt).view(torch.int32))
    y11 = eng.reduce(stream)
    y4 = eng.fused_spmv(xt)
    torch.cuda.synchronize()
    assert eng.launches == {**PERMC_LAUNCHES, "fused": 1, "scatter": 1,
                            "permc_reduce": 1}
    y11_plain, y4_plain = eng.reduce_plain(stream), eng.fused_plain(xt)
    _check_predicated(y11, y11_plain, y4_plain, semiring, "K11")
    _check_predicated(y4, y4_plain, y11_plain, semiring, "K4 fused PERM-C")
    calls = {}
    for fused in (True, False):
        eng.fused = fused
        calls[f"engine call fused={fused}"] = eng(xt)
    _assert_close_to_oracle({"K4 scatter -> K11": y11, "K4 fused": y4,
                             **calls}, _oracle(csr, semiring, x),
                            lay.num_rows, semiring)


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["region_1024", "hub_columns"])
def test_permc_predicated_kernels_match_plain(name, semiring, kind, cuda):
    """On PERM-C layouts (region_1024: 20 regions): K4p fused and K4p
    scatter -> K11p against their plain versions and the unpredicated
    kernels; K4p's stream bit-equal to its plain version."""
    build, region_rows = PLANAR_FIXTURES[name]
    lay = pack_permc(build(), region_rows=region_rows)
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
    act = eng.activity(xt)
    live = eng.live_chunks(act)
    s = eng.scatter_predicated(xt, act)
    assert torch.equal(s.view(torch.int32),
                       eng.scatter_plain(xt, None, act).view(torch.int32))
    y11 = eng.reduce_predicated(s, live)
    y4 = eng.fused_predicated(xt, act)
    full = eng.fused_spmv(xt)
    torch.cuda.synchronize()
    assert eng.launches == {**PERMC_LAUNCHES, "fused": 1, "fused_pred": 1,
                            "scatter_pred": 1, "permc_reduce_pred": 1}
    _check_predicated(y4, eng.fused_plain(xt, None, act), full, semiring,
                      "K4p fused PERM-C")
    _check_predicated(y11, eng.reduce_plain(s, None, live), full, semiring,
                      "K4p scatter -> K11p")
    if kind == "empty":
        assert not y4.any() and not y11.any() and not s.any()


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("semiring", CHUNKED_SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["rmat", "hub_rows", "empty_windows"])
def test_chunked_predicated_kernel_matches_plain(name, semiring, kind, cuda):
    """K7p against its plain version and the unpredicated kernel: ANDOR
    and ADDMIN bit-equal, MULADD within 1e-4 * max|y|."""
    lay = pack_csr_chunks(CHUNKED_CASES[name](), pad_val=semiring.zero,
                          chunk_order="col")
    eng = ChunkedSpMV(lay, semiring, EngineConfig(device="cuda"))
    xt = torch.from_numpy(_frontier(lay.num_cols, kind, semiring.zero)).to(
        cuda)
    act = eng.tile_activity(xt)
    y = eng.spmv_predicated(xt, act)
    y_plain = eng.spmv_predicated_plain(xt, act)
    full = eng.spmv(xt)
    torch.cuda.synchronize()
    assert eng.launches == {"chunked": 1, "chunked_pred": 1}
    if semiring is ArithmeticSemiring:
        scale = max(float(full.abs().max()), 1e-30)
        for ref in (y_plain, full):
            assert float((y - ref).abs().max()) <= 1e-4 * scale
    else:
        for ref in (y_plain, full):
            assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    if kind == "empty":
        assert not act.any() and bool((y == semiring.zero).all())


# ---- the chunked kernel's shared tile; K4 fused's tile columns -----------
@pytest.mark.parametrize("kind", ["full", *FRONTIERS])
@pytest.mark.parametrize("semiring", CHUNKED_SEMIRINGS, ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["hub_window", "hub_rows", "empty_windows"])
def test_chunked_tile_blocks_match_plain(name, semiring, kind, cuda):
    """The chunked kernel ("full") and K7p on a table of 256-entry blocks:
    the hub window's 4,096 chunks spread over thousands of blocks of one
    window group, the hub row's runs cross block boundaries, and empty
    window groups get no block. ANDOR and ADDMIN bit-equal to the plain
    version (and K7p to the unpredicated kernel), MULADD within 1e-4 of
    max|y|."""
    lay = pack_csr_chunks(CHUNKED_CASES[name](), pad_val=semiring.zero,
                          chunk_order="col")
    eng = ChunkedSpMV(lay, semiring, EngineConfig(device="cuda"))
    eng.arrays = chunk_entries(lay, cuda, block_entries=256)
    a = eng.arrays
    group = (a.seg_y.long()[a.blocks[:, 2].long()] // 1024).cpu()
    if name == "hub_window":
        assert int((group == 0).sum()) >= 2000
    if name == "empty_windows":
        assert set(group.tolist()) == {0} and eng.out_len == 4096
    if kind == "full":
        xt = torch.from_numpy(_chunked_x(lay, semiring)).to(cuda)
        y, refs = eng.spmv(xt), (eng.spmv_plain(xt),)
    else:
        xt = torch.from_numpy(_frontier(lay.num_cols, kind,
                                        semiring.zero)).to(cuda)
        act = eng.tile_activity(xt)
        y = eng.spmv_predicated(xt, act)
        refs = (eng.spmv_predicated_plain(xt, act), eng.spmv(xt))
    torch.cuda.synchronize()
    for ref in refs:
        if semiring is ArithmeticSemiring:
            scale = max(float(ref.abs().max()), 1e-30)
            assert float((y - ref).abs().max()) <= 1e-4 * scale
        else:
            assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


def _planar_layout(name, deal):
    build, region_rows = PLANAR_FIXTURES[name]
    if deal == "permc":
        return pack_permc(build(), region_rows=region_rows)
    return pack_planar(build(), region_rows=region_rows, deal=deal)


@pytest.mark.parametrize("kind", ["full", *FRONTIERS])
@pytest.mark.parametrize("deal", ["free", "bucket", "permc"])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["region_4096", "hub_columns"])
def test_planar_fused_tile_columns_match_plain(name, semiring, deal, kind,
                                               cuda):
    """K4 fused ("full") and K4p fused, K1's kernel over the row form and
    over the tile form (windows of one 1,024-column tile, flagged by it),
    against their plain versions (and K4p fused against the unpredicated
    kernel) in every deal: ANDOR bit-equal, MULADD within 1e-5 of
    max|y|."""
    lay = _planar_layout(name, deal)
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    assert eng.pred_entries.col_bits == 10 and bool(
        (eng.pred_entries.deps[:, 3] >= 0).all())
    if kind == "full":
        rng = np.random.default_rng(7)
        x = rng.random(lay.num_cols).astype(np.float32) + 0.5
        x[rng.random(lay.num_cols) < 0.3] = 0.0
        xt = torch.from_numpy(x).to(cuda)
        y, refs = eng.fused_spmv(xt), (eng.fused_plain(xt),)
    else:
        xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
        act = eng.activity(xt)
        y = eng.fused_predicated(xt, act)
        refs = (eng.fused_plain(xt, None, act), eng.fused_spmv(xt))
    torch.cuda.synchronize()
    for ref in refs:
        _check_predicated(y, ref, ref, semiring, f"{deal} {kind}")
    if kind == "empty":
        assert not y.any()


def _empty_region_csr():
    """RMAT 20000/120k with rows 2048..3071, a whole region of 1,024 rows,
    left without entries."""
    g = rmat_csr(20000, 120000, seed=9)
    rows, nnz = g.row_ids(), g.nnz
    keep = (rows < 2048) | (rows >= 3072)
    return csr_from_coo(rows[keep], g.adj_indices[:nnz][keep],
                        g.adj_data[:nnz][keep], g.num_rows, g.num_cols)


# K4 fused's form on the card: name -> (builder, region_rows,
# router_entries arguments); "windows" cuts each region into windows of
# 1,024 columns, "block_edges" cuts the form into blocks of 100 elements,
# which the RMAT graph's hub rows cross; "stored_zeros" holds explicit
# zeros, so its ANDOR form keeps the value stream
PLANAR_FORM_CASES = {
    "region_4096": (PLANAR_FIXTURES["region_4096"][0], 4096, {}),
    "hub_columns": (PLANAR_FIXTURES["hub_columns"][0], None, {}),
    "windows": (PLANAR_FIXTURES["region_1024"][0], 1024, {"col_bits": 10}),
    "block_edges": (PLANAR_FIXTURES["rmat"][0], None,
                    {"block_entries": 100}),
    "empty_region": (_empty_region_csr, 1024, {}),
    "stored_zeros": (stored_zeros_csr, None, {}),
}
def _planar_form_engine(case, deal, semiring, **extra):
    build, region_rows, kw = PLANAR_FORM_CASES[case]
    csr = build()
    lay = (pack_permc(csr, region_rows=region_rows) if deal == "permc"
           else pack_planar(csr, region_rows=region_rows, deal=deal))
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    if kw or extra:      # the engine's form, cut otherwise
        e = eng.entries
        eng.use_entries(router_entries(eng, "row", **{
            "col_bits": e.col_bits, "values": e.vals is not None, **kw,
            **extra}))
    return csr, lay, eng


@pytest.mark.parametrize("deal", ["free", "bucket", "permc"])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("case", list(PLANAR_FORM_CASES))
def test_planar_form_kernel_matches_plain(case, semiring, deal, cuda):
    """K4 fused (K1's kernel over the planar engine's row-sorted form;
    ANDOR's without values unless a stored value is zero) against the
    form's plain walk, K4 scatter -> K3's plain versions and the float64
    oracle (ANDOR bit-equal, MULADD within 1e-5 of max|y|), with no K5
    launch on any deal; an all-zero x gives zeros."""
    csr, lay, eng = _planar_form_engine(case, deal, semiring)
    e = eng.entries
    assert (e.vals is None) == (semiring is LogicalSemiring and bool(
        (csr.adj_data[:csr.nnz] != 0).all()))
    if case == "windows":
        assert e.deps.shape[0] > lay.num_regions
    if case == "block_edges":
        row = eng.entries_index()[1].cpu().numpy()
        e0 = e.blocks[1:, 0].cpu().numpy()
        assert (row[e0 - 1] == row[e0]).any()     # a row crosses a block
    if case == "empty_region":
        assert not (eng.entries_index()[1] // 1024 == 2).any()
    x = _router_x(lay.num_cols)
    xt = torch.from_numpy(x).to(cuda)
    y = eng.fused_spmv(xt)
    zero = eng.fused_spmv(torch.zeros_like(xt))
    refs = (eng.fused_entries_plain(xt), eng.fused_plain(xt))
    torch.cuda.synchronize()
    for ref in refs:
        _check_predicated(y, ref, ref, semiring, f"{case} {deal}")
    assert not zero.any()
    assert eng.launches["fused"] == 2 and eng.launches["xperm"] == 0
    _assert_close_to_oracle({"K4 fused": y}, _oracle(csr, semiring, x),
                            lay.num_rows, semiring)


@pytest.mark.parametrize("deal", ["free", "bucket", "permc"])
@pytest.mark.parametrize("case", ["region_4096", "windows", "block_edges"])
def test_planar_form_kernel_with_values(case, deal, cuda):
    """ANDOR K4 fused over the form with its value stream (the instance
    that reads values) gives the engine's form without values' y bit for
    bit, and its own plain walk's."""
    _, lay, eng = _planar_form_engine(case, deal, LogicalSemiring)
    assert eng.entries.vals is None
    xt = torch.from_numpy(_frontier(lay.num_cols, "5pct", 0.0)).to(cuda)
    y = eng.fused_spmv(xt)
    _, _, full = _planar_form_engine(case, deal, LogicalSemiring,
                                     values=True)
    assert full.entries.vals is not None
    yv = full.fused_spmv(xt)
    torch.cuda.synchronize()
    _check_predicated(yv, y, full.fused_entries_plain(xt), LogicalSemiring,
                      f"{case} {deal}")


@pytest.mark.parametrize("engine", ["roll", "planar", "chunked"])
def test_spmspv_module_on_card(engine, cuda):
    """The SpMSpV module's product on CUDA tensors launches only the
    predicated kernels of its engine and equals the float64 oracle."""
    from graphlily_tpu_torch.io import csr2csc
    from graphlily_tpu_torch.module import SpMSpVModule
    csr = (rmat_csr(50000, 150000, seed=5) if engine == "planar"
           else rmat_csr(3000, 40000, seed=5))
    util_round_csr_matrix_dim(csr, 1024, 1024)
    cfg = EngineConfig(engine="auto" if engine == "chunked" else "router",
                       device="cuda")
    spmv = None
    if engine != "chunked":
        spmv = SpMVModule(cfg)
        spmv.set_semiring(LogicalSemiring)
        spmv.load_and_format_matrix(csr)
    mod = SpMSpVModule(cfg)
    mod.set_semiring(LogicalSemiring)
    mod.load_and_format_matrix(csr2csc(csr), reuse_from=spmv)
    assert mod.engine_name == engine
    x = _frontier(csr.num_cols, "5pct", 0.0, seed=4)
    y = mod.apply_dense(torch.from_numpy(x).to(cuda))
    idx = np.nonzero(x)[0]
    want = mod.compute_reference_results((idx, x[idx]))
    np.testing.assert_array_equal(y.cpu().numpy(), want)
    launched = {k for k, v in mod.engine.launches.items() if v}
    assert launched and all(k.endswith("pred") for k in launched)


# ---- tropical engine: K4 / K4p scatter (ADDMIN), K8, K9, K10 -----------------
SPLIT_FORMATS = ["planes", "triples"]
SPLIT_KEY = {"planes": "split", "triples": "split_triples"}


def _tropical_engine(name, fmt, deal):
    """(graph, its TropicalStages on the card: the three passes and the
    walk)."""
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    csr = build()
    lay = pack_tropical(csr, EngineConfig(planar_deal=deal),
                        region_rows=region_rows, kb=kb, split_format=fmt)
    return csr, TropicalStages(lay, EngineConfig(device="cuda"))


def _tropical_x(ncols, seed=7):
    """x >= 0 (the engine's contract) with unreached FLOAT_INF entries."""
    rng = np.random.default_rng(seed)
    x = (rng.random(ncols) * 100).astype(np.float32)
    x[rng.random(ncols) < 0.3] = TropicalSemiring.zero
    return x


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _tropical_launches(fmt, **counts):
    out = {"fused": 0, "fused_pred": 0, "xperm": 0, "scatter": 0,
           "scatter_pred": 0, "split": 0, "split_triples": 0,
           "window_reduce": 0}
    counts[SPLIT_KEY[fmt]] = counts.pop("split", 0)
    return {**out, **counts}


@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("fmt", SPLIT_FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_kernels_match_plain(name, fmt, deal, cuda):
    """K4 scatter (ADDMIN), K8 or K9 and K10, each on the stage before's
    kernel output, bit-equal to its plain version; the engine call (the
    walk) equals the oracle."""
    csr, eng = _tropical_engine(name, fmt, deal)
    x = _tropical_x(eng.walk.num_cols)
    xt = torch.from_numpy(x).to(cuda)
    g1 = eng.scatter(xt)
    assert g1.dtype == torch.int32
    assert _same_bits(g1, eng.scatter_plain(xt))
    g2 = eng.split(g1)
    assert _same_bits(g2, eng.split_plain(g1))
    out = eng.window_reduce(g2)
    assert _same_bits(out, eng.window_reduce_plain(g2))
    y = eng.walk(xt)
    torch.cuda.synchronize()
    assert eng.launches == _tropical_launches(
        fmt, scatter=1, split=1, window_reduce=1, fused=1)
    want = _oracle(csr, TropicalSemiring, x).astype(np.float32)
    np.testing.assert_array_equal(y.cpu().numpy(), want)


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("fmt", SPLIT_FORMATS)
@pytest.mark.parametrize("name", ["multi_region", "hub_row"])
def test_tropical_predicated_scatter_matches_plain(name, fmt, kind, cuda):
    """K4p scatter (ADDMIN) bit-equal to its plain version and to the
    unpredicated K4 scatter (skipped pieces hold 0, the encoding of
    FLOAT_INF); the predicated call (the predicated walk) bit-equal to the
    unpredicated one. The frontier holds a source at distance 0."""
    _, eng = _tropical_engine(name, fmt, "free")
    x = _frontier(eng.walk.num_cols, kind, TropicalSemiring.zero)
    if kind != "empty":
        x[5] = 0.0
    xt = torch.from_numpy(x).to(cuda)
    act = eng.walk.activity(xt)
    g1 = eng.scatter_predicated(xt, act)
    assert _same_bits(g1, eng.scatter_plain(xt, act))
    assert _same_bits(g1, eng.scatter(xt))
    y, full = eng.walk.call_predicated(xt), eng.walk(xt)
    torch.cuda.synchronize()
    assert _same_bits(y, full)
    assert eng.launches == _tropical_launches(
        fmt, scatter=1, scatter_pred=1, fused=1, fused_pred=1)
    if kind == "empty":
        assert not act.any() and bool((y == TropicalSemiring.zero).all())
    else:
        assert bool(act[0])   # the source's tile, at distance 0


def test_tropical_sssp_on_card(cuda):
    """SSSP with engine="router" on the card: SpMV and SpMSpV share one
    TropicalSpMV, pull, push and pull_push equal the oracle, and only the
    walk's kernels ran: the engine counts no other."""
    from graphlily_tpu_torch.apps import SSSP
    sssp = SSSP(EngineConfig(engine="router"))
    sssp.load_and_format_matrix(rmat_csr(12000, 60000, seed=7))
    eng = sssp.SpMV_.engine
    assert sssp.SpMV_.engine_name == "tropical"
    assert sssp.SpMSpV_.engine is eng
    want = sssp.compute_reference_results(0, 6)
    for run in (sssp.pull(0, 6), sssp.push(0, 6), sssp.pull_push(0, 6)):
        np.testing.assert_array_equal(np.asarray(run, np.float64), want)
    assert eng.launches["fused"] > 0 and eng.launches["fused_pred"] > 0
    assert set(eng.launches) == {"fused", "fused_pred"}


def _tropical_negative_x(ncols, seed=5):
    """_tropical_x with a third of its entries negated and three far below
    -FLOAT_INF: the encodings the walk must keep equal to the three
    passes' (ROADMAP queue 3 F2)."""
    rng = np.random.default_rng(seed)
    x = _tropical_x(ncols, seed)
    x[rng.random(ncols) < 0.3] *= -1
    x[:3] = -3e9
    return x


def _walk_is_three_pass(eng, out, three) -> bool:
    """The walk's out holds K10's as its prefix and 0 past it."""
    n = eng.num_windows * 128
    return (out.dtype == torch.int32
            and out.numel() == eng.walk.planar.out_len
            and torch.equal(out[:n], three) and not bool(out[n:].any()))


@pytest.mark.parametrize("sign", ["nonneg", "negative_x"])
@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("fmt", SPLIT_FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_walk_matches_plain_and_three_passes(name, fmt, deal, sign,
                                                      cuda):
    """The ADDMIN walk (K1's kernel over the pass-1 row form) bit-equal to
    its plain version and to window_reduce(split(scatter(x))) through the
    three kernels, on x >= 0 and on negative x."""
    _, eng = _tropical_engine(name, fmt, deal)
    x = (_tropical_x(eng.walk.num_cols) if sign == "nonneg"
         else _tropical_negative_x(eng.walk.num_cols))
    xt = torch.from_numpy(x).to(cuda)
    out = eng.walk.fused(xt)
    three = eng.window_reduce(eng.split(eng.scatter(xt)))
    torch.cuda.synchronize()
    assert torch.equal(out, eng.walk.fused_plain(xt))
    assert _walk_is_three_pass(eng, out, three)
    assert eng.launches == _tropical_launches(
        fmt, fused=1, scatter=1, split=1, window_reduce=1)


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("fmt", SPLIT_FORMATS)
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_tropical_predicated_walk_matches_plain(name, fmt, kind, cuda):
    """The predicated walk (K1p's kernel over the pass-1 tile form) bit-
    equal to its plain version, to the unpredicated walk and to the three
    kernels' out on a frontier x."""
    _, eng = _tropical_engine(name, fmt, "free")
    x = _frontier(eng.walk.num_cols, kind, TropicalSemiring.zero)
    if kind != "empty":
        x[5] = 0.0
    xt = torch.from_numpy(x).to(cuda)
    act = eng.walk.activity(xt)
    out = eng.walk.fused_predicated(xt, act)
    three = eng.window_reduce(eng.split(eng.scatter(xt)))
    torch.cuda.synchronize()
    assert torch.equal(out, eng.walk.fused_plain(xt, act))
    assert torch.equal(out, eng.walk.fused(xt))
    assert _walk_is_three_pass(eng, out, three)
    if kind == "empty":
        assert not act.any() and not out.any()


# ---- K1 and K8 over the forms derived at engine init -------------------------
ROUTER_ORDERS = ["deposit", "row"]


def _router_x(ncols, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.random(ncols).astype(np.float32) + 0.5
    x[rng.random(ncols) < 0.3] = 0.0
    return x


def _router_engine(name, semiring, **entries_kw):
    build, region_rows = FIXTURES[name]
    csr = build()
    lay = pack_router(csr, region_rows=region_rows)
    eng = RouterSpMV(lay, semiring, EngineConfig(device="cuda"))
    if entries_kw:
        eng.use_entries(router_entries(eng, **entries_kw))
    return csr, lay, eng


def _check_k1(eng, xt, semiring, label, act=None):
    """K1 (K1p with `act`) against the plain walk of its form, K2 -> K3's
    plain versions and, predicated, the unpredicated kernel: ANDOR
    bit-equal, MULADD within 1e-5 of max|y|."""
    if act is None:
        y = eng.fused_spmv(xt)
        refs = (eng.fused_entries_plain(xt), eng.fused_plain(xt))
    else:
        y = eng.fused_predicated(xt, act)
        refs = (eng.fused_entries_plain(xt, act),
                eng.fused_plain(xt, None, act), eng.fused_spmv(xt))
    torch.cuda.synchronize()
    for ref in refs:
        _check_predicated(y, ref, ref, semiring, label)
    return y


@pytest.mark.parametrize("order", ROUTER_ORDERS)
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_router_fused_entries_match_plain(name, semiring, order, cuda):
    """K1 over its derived form, in row order (the engine's) or deposit
    order (K1p's), against the form's plain walk, K2 -> K3's plain versions
    and the float64 oracle."""
    csr, lay, eng = _router_engine(name, semiring, order=order)
    x = _router_x(lay.num_cols)
    y = _check_k1(eng, torch.from_numpy(x).to(cuda), semiring, name)
    assert eng.launches["fused"] == 1
    _assert_close_to_oracle({"K1": y}, _oracle(csr, semiring, x),
                            lay.num_rows, semiring)


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_router_fused_pred_entries_match_plain(name, semiring, kind, cuda):
    """K1p over the deposit-order form at empty, 1-vertex and 5% frontiers
    against the form's plain walk, K2p -> K3's plain versions and K1."""
    _, lay, eng = _router_engine(name, semiring)
    xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
    y = _check_k1(eng, xt, semiring, f"{name} {kind}", eng.activity(xt))
    assert eng.launches["fused_pred"] == 1
    if kind == "empty":
        assert not y.any()


@pytest.mark.parametrize("kind", ["full", *FRONTIERS])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("block_entries", [20, 100])
@pytest.mark.parametrize("name", ["dense", "hub_page", "region_1024"])
def test_router_fused_deposit_across_blocks(name, block_entries, semiring,
                                            kind, cuda):
    """Blocks that start inside a segment (a deposit for K1p, a region's
    column window for K1), at an offset that is not a multiple of 8, and
    K1's forms cut to windows of 1,024 columns: K1 and K1p against their
    plain versions."""
    _, lay, eng = _router_engine(name, semiring)
    eng.use_entries(router_entries(eng, "row", block_entries, col_bits=10))
    eng.use_entries(router_entries(eng, "deposit", block_entries), pred=True)
    for e in (eng.entries, eng.pred_entries):
        starts = set(e.deps[:, 0].tolist())
        e0 = e.blocks[:, 0].tolist()
        assert any(b not in starts for b in e0)
        assert any(b % 8 for b in e0)
    if kind == "full":
        _check_k1(eng, torch.from_numpy(_router_x(lay.num_cols)).to(cuda),
                  semiring, name)
    else:
        xt = torch.from_numpy(_frontier(lay.num_cols, kind, 0.0)).to(cuda)
        _check_k1(eng, xt, semiring, f"{name} {kind}", eng.activity(xt))


@pytest.mark.parametrize("order", ROUTER_ORDERS)
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
def test_router_fused_row_run_across_warps(semiring, order, cuda):
    """Runs of one row crossing a warp's 256 elements (the RMAT graph's
    hub rows, runs of up to 383 elements in deposit order): each folds
    across lanes and warps; K1 against its plain versions."""
    _, lay, eng = _router_engine("rmat", semiring, order=order)
    row = eng.entries_index()[1].cpu().numpy()
    edge = np.arange(256, len(row), 256)
    assert (row[edge - 1] == row[edge]).any()
    assert eng.entries.blocks.shape[0] > 1
    _check_k1(eng, torch.from_numpy(_router_x(lay.num_cols)).to(cuda),
              semiring, f"rmat {order}")


def planes_walk(lay, g1: np.ndarray) -> np.ndarray:
    """The split over the layout's deposit planes, in numpy: every entry
    v < 0 of a live piece's plane at (s, l) moves g1[in_order[t*kb + k]][s,
    v & 127] to g2[target2[t, j]][s, l] (K8 before its compact form)."""
    g1 = np.asarray(g1).reshape(-1)
    target = deposit_targets(lay.rg2, lay.dstep2, lay.f2, block=lay.qblk2)
    t, j = np.nonzero(lay.rg2[:, :lay.dstep2, 1] > 0)
    w1 = lay.rg2[t, j, 0].astype(np.int64)
    planes = lay.planes2.reshape(lay.nsteps2, -1, 1024)[t, w1 >> 8]
    pc, e = np.nonzero(planes < 0)
    chunk = lay.in_order.astype(np.int64)[t * lay.kb + (w1 & 0xFF)]
    src = chunk[pc] * 1024 + (e & ~127) + (planes[pc, e].astype(np.int64)
                                           & 127)
    out = np.zeros(len(lay.c_win) * 1024, np.int32)
    out[target[t, j].astype(np.int64)[pc] * 1024 + e] = g1[src]
    return out.reshape(-1, 8, 128)


@pytest.mark.parametrize("deal", ["free", "bucket"])
@pytest.mark.parametrize("name", list(TROPICAL_FIXTURES))
def test_split_pieces_match_planes_walk(name, deal, cuda):
    """K8 over its compact form bit-equal to its plain version and to the
    walk of the layout's deposit planes, on a random g1 (every value
    moves)."""
    build, region_rows, kb = TROPICAL_FIXTURES[name]
    lay = pack_tropical(build(), EngineConfig(planar_deal=deal),
                        region_rows=region_rows, kb=kb,
                        split_format="planes")
    eng = TropicalStages(lay, EngineConfig(device="cuda"))
    g1 = np.random.default_rng(3).integers(
        1, 2**31 - 1, eng.g1_numel).astype(np.int32)
    g1t = torch.from_numpy(g1).to(cuda)
    g2 = eng.split(g1t)
    torch.cuda.synchronize()
    assert eng.launches["split"] == 1
    assert _same_bits(g2, eng.split_plain(g1t))
    np.testing.assert_array_equal(g2.cpu().numpy(), planes_walk(lay, g1))


def test_split_pieces_cross_passes_and_blocks(cuda):
    """Pieces longer than a warp's 64 elements (two 32-element passes at
    once) and than 128, and a last block of fewer than 8 pieces: K8
    bit-equal to the planes walk."""
    build, region_rows, kb = TROPICAL_FIXTURES["hub_row"]
    lay = pack_tropical(build(), EngineConfig(), region_rows=region_rows,
                        kb=kb, split_format="planes")
    eng = TropicalStages(lay, EngineConfig(device="cuda"))
    p = eng.arrays.split
    count = ((p.runs.long() >> 14) & 255).sum(1)
    assert int(count.max()) > 128 and p.pieces.shape[0] % 8
    g1 = np.random.default_rng(5).integers(
        1, 2**31 - 1, eng.g1_numel).astype(np.int32)
    g2 = eng.split(torch.from_numpy(g1).to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(g2.cpu().numpy(), planes_walk(lay, g1))


# ---- K4 scatter and K4p fused over the forms derived at engine init ---------
# name -> (store-form cut); "block_edges" starts blocks inside pieces at
# offsets that are not a multiple of 8, "segment_cap" cuts blocks at every
# third piece
STORE_CUTS = {"engine": {}, "block_edges": {"block_entries": 100},
              "segment_cap": {"block_segments": 3}}


def _store_engine(name, semiring, deal, cut):
    if semiring is TropicalSemiring:
        _, teng = _tropical_engine(name, "planes", deal)
        eng = teng.walk.planar
    else:
        eng = PlanarSpMV(_planar_layout(name, deal), semiring,
                         EngineConfig(device="cuda"))
    if STORE_CUTS[cut]:
        eng.store_entries = router_entries(eng, "stream", **STORE_CUTS[cut])
    return eng


# PERM-C layouts serve MULADD/ANDOR only (as in JAX)
STORE_DEALS = [(s, d) for s in CHUNKED_SEMIRINGS
               for d in ("free", "bucket", "permc")
               if not (s is TropicalSemiring and d == "permc")]


@pytest.mark.parametrize("kind", ["full", *FRONTIERS])
@pytest.mark.parametrize("cut", list(STORE_CUTS))
@pytest.mark.parametrize("semiring,deal", STORE_DEALS,
                         ids=[f"{s.name}-{d}" for s, d in STORE_DEALS])
def test_planar_store_kernel_matches_plain(semiring, deal, cut, kind, cuda):
    """K4 scatter ("full") and K4p scatter over the store form, in all
    three semirings (ADDMIN on the tropical engine's pass 1, "free" and
    "bucket") and deals: the stream bit-equal to the plain version through
    the layout (K5 -> gather for "bucket") and to the form's walk, with
    no K5 launch; K4 scatter writes the zeros of the unfilled lanes itself
    (also over a stream of -1 bits); a predicated stream is also
    bit-equal to the unpredicated one on its frontier (skipped pieces hold
    the zero fill, the encoding of FLOAT_INF for ADDMIN)."""
    name = "multi_region" if semiring is TropicalSemiring else "hub_columns"
    eng = _store_engine(name, semiring, deal, cut)
    e = eng.store_entries
    if cut == "block_edges":
        assert any(b % 8 for b in e.blocks[:, 0].tolist())
    if cut == "segment_cap":
        assert e.max_segments <= 3 and e.blocks.shape[0] > 1
    if kind == "full":
        x = (_tropical_x(eng.num_cols) if semiring is TropicalSemiring
             else _router_x(eng.num_cols))
        xt = torch.from_numpy(x).to(cuda)
        s, act = eng.scatter(xt), None
        # with tails the kernel writes every lane itself: over a stream
        # of -1 bits too
        assert e.tails is not None
        poisoned = torch.full((s.numel(),), -1, dtype=torch.int32,
                              device=cuda).view(s.dtype)
        assert _same_bits(eng._launch_store(xt, None, poisoned), s)
    else:
        x = _frontier(eng.num_cols, kind, semiring.zero)
        xt = torch.from_numpy(x).to(cuda)
        act = (eng.activity(xt) if semiring is not TropicalSemiring else
               (xt.reshape(-1, 1024) != semiring.zero).any(1).to(torch.uint8))
        s = eng.scatter_predicated(xt, act)
        assert _same_bits(s, eng.scatter(xt))
    refs = (eng.scatter_plain(xt, None, act),
            eng.scatter_entries_plain(xt, act))
    torch.cuda.synchronize()
    for ref in refs:
        assert _same_bits(s, ref), (deal, cut, kind)
    assert eng.launches["xperm"] == 0
    if kind == "empty":
        assert not s.any()


@pytest.mark.parametrize("kind", FRONTIERS)
@pytest.mark.parametrize("deal", ["free", "bucket", "permc"])
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", ["rmat", "region_1024"])
def test_planar_tile_form_kernel_matches_oracle(name, semiring, deal, kind,
                                               cuda):
    """K4p fused over the tile form, also cut into blocks of 100 elements
    (blocks that start inside a tile's segment), against the tile form's
    walk, K4p scatter -> K3's plain versions and the float64 oracle on the
    frontier x: ANDOR bit-equal, MULADD within 1e-5 of max|y|; no K5."""
    build, region_rows = PLANAR_FIXTURES[name]
    csr = build()
    lay = (pack_permc(csr, region_rows=region_rows) if deal == "permc"
           else pack_planar(csr, region_rows=region_rows, deal=deal))
    eng = PlanarSpMV(lay, semiring, EngineConfig(device="cuda"))
    x = _frontier(lay.num_cols, kind, 0.0)
    xt = torch.from_numpy(x).to(cuda)
    act = eng.activity(xt)
    ys = [eng.fused_predicated(xt, act)]
    e = eng.pred_entries
    eng.use_entries(router_entries(eng, "row", 100, col_bits=e.col_bits,
                                   values=e.vals is not None), pred=True)
    ys.append(eng.fused_predicated(xt, act))
    refs = (eng.fused_entries_plain(xt, act, eng.pred_entries),
            eng.fused_plain(xt, None, act))
    torch.cuda.synchronize()
    assert eng.launches["fused_pred"] == 2 and eng.launches["xperm"] == 0
    for y in ys:
        for ref in refs:
            _check_predicated(y, ref, ref, semiring, f"{name} {deal} {kind}")
        _assert_close_to_oracle({"K4p fused": y}, _oracle(csr, semiring, x),
                                lay.num_rows, semiring)


# ---- the empty matrix (ROADMAP queue 3 F1) ------------------------------------
@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("engine,deal", [("roll", "free"), ("planar", "free"),
                                         ("planar", "bucket"),
                                         ("planar", "permc")],
                         ids=["roll", "free", "bucket", "permc"])
def test_empty_matrix_gives_zeros_on_card(engine, deal, semiring, cuda):
    """A 2048 x 2048 matrix with no entry: every form has no block, the
    kernels launch nothing, and SpMV and SpMSpV through the modules give
    y = 0 on the card."""
    from graphlily_tpu_torch.io import csr2csc
    from graphlily_tpu_torch.module import SpMSpVModule
    e = np.zeros(0, np.int64)
    csr = csr_from_coo(e, e, np.zeros(0, np.float32), 2048, 2048)
    cfg = EngineConfig(engine=engine, planar_deal=deal)
    mod = SpMVModule(cfg)
    mod.set_semiring(semiring)
    mod.load_and_format_matrix(csr)
    assert mod.engine_name == engine
    assert mod.engine.entries.blocks.shape[0] == 0
    y = mod.apply(torch.ones(2048, device=cuda))
    spmspv = SpMSpVModule(cfg)
    spmspv.set_semiring(semiring)
    spmspv.load_and_format_matrix(csr2csc(csr), reuse_from=mod)
    x = torch.zeros(2048, device=cuda)
    x[3], x[1500] = 1.0, 2.5
    ys = spmspv.apply_dense(x)
    torch.cuda.synchronize()
    assert y.is_cuda and y.shape == (2048,) and not y.any()
    assert ys.is_cuda and not ys.any()


# ---- phase C over the region-group table: K3 and K11 ----------------------
REDUCE_CASES = ["default", "groups_of_1", "region_16384", "empty"]
REDUCE_DEALS = ["roll", "free", "bucket", "permc"]


def _reduce_engine(deal, case, semiring):
    """An engine of `deal` for K3 (roll, "free", "bucket") or K11 (PERM-C):
    rmat 20000/120k in 20 regions of 1,024 rows ("default"; "groups_of_1"
    with a table of one chunk a group, so every region of several chunks
    reaches y through vector reductions alone), in 2 regions of 16,384 rows
    (a 64 KB tile: the shared-memory opt-in), or the empty matrix."""
    from graphlily_tpu_torch.ops.router import reduce_groups
    if case == "empty":
        e = np.zeros(0, np.int64)
        csr = csr_from_coo(e, e, np.zeros(0, np.float32), 2048, 2048)
        region_rows = None
    else:
        csr = rmat_csr(20000, 120000, seed=9)
        region_rows = 16384 if case == "region_16384" else 1024
    if deal == "roll":
        eng = RouterSpMV(pack_router(csr, region_rows=region_rows), semiring,
                         EngineConfig(device="cuda"))
    elif deal == "permc":
        eng = PlanarSpMV(pack_permc(csr, region_rows=region_rows), semiring,
                         EngineConfig(device="cuda"))
    else:
        eng = PlanarSpMV(pack_planar(csr, region_rows=region_rows,
                                     deal=deal), semiring,
                         EngineConfig(device="cuda"))
    if case == "groups_of_1":
        eng.groups = reduce_groups(eng.arrays.c_code, 1)
    return csr, eng


@pytest.mark.parametrize("semiring", [ArithmeticSemiring, LogicalSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("case", REDUCE_CASES)
@pytest.mark.parametrize("deal", REDUCE_DEALS)
def test_reduce_groups_kernel_matches_plain(deal, case, semiring, cuda):
    """K3 (roll, "free", "bucket") and K11 (PERM-C) over the region-group
    table: ANDOR bit-equal to the plain version and, clamped, to the
    float64 oracle; MULADD within 1e-4 * max|y64| of both (the tile sums
    and a region's vector reductions land in any order)."""
    csr, eng = _reduce_engine(deal, case, semiring)
    g = eng.groups.groups
    if case == "empty":
        assert g.shape == (0, 4)
    elif case == "groups_of_1":
        assert int(g[:, 1].max()) == 1 and not bool(g[:, 3].all())
    rng = np.random.default_rng(7)
    x = rng.random(eng.num_cols).astype(np.float32) + 0.5
    x[rng.random(eng.num_cols) < 0.3] = 0.0
    xt = torch.from_numpy(x).to(cuda)
    stream = eng.scatter(xt)
    y = eng.reduce(stream)
    y_plain = eng.reduce_plain(stream)
    torch.cuda.synchronize()
    key = "permc_reduce" if deal == "permc" else "reduce"
    assert eng.launches[key] == 1
    assert sum(eng.launches.values()) == 2       # scatter and the reduce
    want = _oracle(csr, semiring, x)
    n = len(want)
    if semiring is LogicalSemiring:
        assert torch.equal(y.view(torch.int32), y_plain.view(torch.int32))
        np.testing.assert_array_equal(
            (y[:n] != 0).cpu().numpy().astype(np.float64), want)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float((y - y_plain).abs().max()) <= 1e-4 * scale
        err = np.abs(y[:n].cpu().numpy().astype(np.float64) - want).max()
        assert err <= 1e-4 * scale
    if case == "empty":
        assert not y.any()


@pytest.mark.parametrize("deal", ["roll", "permc"])
def test_reduce_groups_kernel_refuses_foreign_arrays(deal, cuda):
    """K3 and K11 read the table derived from the engine's own arrays."""
    _, eng = _reduce_engine(deal, "default", ArithmeticSemiring)
    _, other = _reduce_engine(deal, "default", ArithmeticSemiring)
    stream = eng.scatter(torch.ones(eng.num_cols, device=cuda))
    with pytest.raises(ValueError, match="own arrays"):
        eng.reduce(stream, other.arrays)
