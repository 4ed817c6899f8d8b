"""CUDA kernels K1 (fused), K2 (scatter), K3 (reduce) of the roll router,
K4 (scatter, fused) and K5 (xperm) of the planar router and the chunked
K6/K7 kernel against their plain PyTorch versions, on the card.

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
    assert eng.launches == {"fused": 1, "scatter": 1, "reduce": 1}

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
    assert eng.launches == want


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
                            "xperm": xperms}
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
    assert eng.launches == want


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
    assert eng.launches == {"chunked": 1}
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
    assert mod.engine.launches == {"chunked": 1}
    want = _oracle(csr, semiring, x)
    if semiring is ArithmeticSemiring:
        assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()
    elif semiring is LogicalSemiring:
        np.testing.assert_array_equal(y, want)
    else:
        np.testing.assert_allclose(y, want, rtol=2.0**-23, atol=0)
