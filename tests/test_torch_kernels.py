"""CUDA kernels K1 (fused), K2 (scatter), K3 (reduce) of the roll router,
K4 (scatter, fused) and K5 (xperm) of the planar router, the chunked
K6/K7 kernel, and the frontier-predicated forms K1p, K2p, K3p, K4p and K7p
(SpMSpV, for empty, 1-vertex and 5% frontiers) against their plain
PyTorch versions and the unpredicated kernels, on the card.

Needs a CUDA card and nvcc; every test skips without a card. Imports only
torch and the port (no jax), so on a machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: K2, K4 scatter and K5 are pure copies of products or of x and
must equal their plain versions bit for bit. K1, K4 fused and K3 add with float atomics in an order that
changes from run to run: ANDOR adds 0/1 counts and stays exact; MULADD is
held to max|y - y64| <= 1e-5 * max|y64| against the float64 oracle at
these sizes (the smoke test's googleplus bound is 1e-4, for hub rows of up
to ~1e5 terms). The chunked kernel: ANDOR and ADDMIN bit-equal to the
plain version, MULADD within 1e-4 * max|y64| (its atomics land in any
order; hub windows fold thousands of chunks into 128 rows).
"""
import numpy as np
import pytest
import torch

from graphlily_tpu_torch import (ArithmeticSemiring, LogicalSemiring,
                                 TropicalSemiring, EngineConfig)
from graphlily_tpu_torch.io import (rmat_csr, pack_router, pack_planar,
                                    pack_csr_chunks,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule
from graphlily_tpu_torch.ops import RouterSpMV, PlanarSpMV, ChunkedSpMV

from test_torch_fixtures import (FIXTURES, PLANAR_FIXTURES, CHUNKED_FIXTURES,
                                 hub_window_csr)

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
    y_reduce = eng.reduce(stream)
    y_fused = eng.fused_spmv(xt)
    y_fused_plain = eng.fused_plain(xt)
    torch.cuda.synchronize()
    xperms = 3 if deal == "bucket" else 0   # xperm, scatter, fused
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
    of its branch (K5 first for bucket layouts), never the plain versions."""
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
    want["xperm"] = int(deal == "bucket")
    assert eng.launches == {**want, "fused_pred": 0, "scatter_pred": 0,
                            "reduce_pred": 0}


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
    xperms = 3 if deal == "bucket" else 0
    assert eng.launches == {"fused": 1, "scatter": 0, "reduce": 0,
                            "xperm": xperms, "fused_pred": 1,
                            "scatter_pred": 1, "reduce_pred": 1}
    _check_predicated(y4, eng.fused_plain(xt, None, act), full, semiring,
                      "K4p fused")
    _check_predicated(y3, eng.reduce_plain(s, None, live), full, semiring,
                      "K4p scatter -> K3p")


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
