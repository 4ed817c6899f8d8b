"""The unpredicated walk of the derived row forms (K1, K4 fused and the
tropical walk: `glt_router_fused`, the persistent, software-pipelined
`router_fused_kernel`) on forms that stress its pipeline: an empty form,
forms of one and five elements (shorter than a thread's vector of 8), a
ragged tail (N not a multiple of 8), one hub row whose run crosses passes
and rows (the loads of the next pass are in flight while it folds), rows
cut at BLOCK_SEGMENTS segments and a shared table of records above the
default 48 KB, more table rows than any H100 grid holds (132 SMs x at most
8 blocks of 256 threads) and fewer than it has SMs.

Each case runs in MULADD, ANDOR without and with the value stream (the
planar engine's form) and ADDMIN (the tropical pass 1's form), and is
held to the form's plain walk (`fused_entries_plain`): ANDOR and ADDMIN
bit for bit, MULADD within 1e-5 of max|y| (float atomics in any order,
tests/test_torch_kernels.py's tolerance). The forms are the engines' own,
cut by `router_entries`, or a prefix of one (its first k elements, its
blocks cut at k).

The form checks run on the CPU; the kernel tests need a CUDA card and
skip without one. Imports only torch and the port (no jax), so on the
card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_fused_walk.py
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from graphlily_tpu_torch import (ArithmeticSemiring, LogicalSemiring,
                                 TropicalSemiring, EngineConfig)
from graphlily_tpu_torch.io import rmat_csr, pack_planar, pack_tropical
from graphlily_tpu_torch.ops import PlanarSpMV, TropicalSpMV
from graphlily_tpu_torch.ops.router import (BLOCK_SEGMENTS,
                                            ENTRIES_PER_BLOCK, VECTOR,
                                            _vector_storage, router_entries)

from test_torch_fixtures import hub_row_csr, one_thread  # noqa: F401

OPS = ["muladd", "andor", "andor_values", "addmin"]
# more rows than this are more than any H100 grid of this kernel holds
MAX_GRID = 132 * 8

GRAPHS = {
    "rmat": lambda: rmat_csr(12000, 60000, seed=7),
    "hub": hub_row_csr,       # row 0: 5,000 of 25,000 entries
}

# name -> (graph, router_entries arguments, prefix length or None)
CASES = {
    "empty": ("rmat", {}, 0),
    "one": ("rmat", {}, 1),
    "short": ("rmat", {}, 5),
    "ragged": ("rmat", {}, 10003),
    "hub": ("hub", {}, None),
    "hub_rows": ("hub", {"block_entries": 1000}, None),
    "segment_cut": ("rmat", {"col_bits": 1}, None),
    "big_table": ("rmat", {"col_bits": 1, "block_segments": 2048,
                           "block_entries": 8192}, None),
    "many_rows": ("rmat", {"block_entries": 16}, None),
    "few_rows": ("rmat", {}, None),
}


@functools.cache
def _layout(graph: str, tropical: bool):
    csr = GRAPHS[graph]()
    if tropical:
        return pack_tropical(csr, EngineConfig(planar_deal="free"),
                             region_rows=2048, kb=4, split_format="planes")
    return pack_planar(csr, region_rows=2048, deal="free")


def _prefix(e, k: int):
    """The first k elements of the form `e`: its rows that start below k,
    the last cut at k, and the segments that start below k."""
    nseg = int((e.deps[:, 0] < k).sum())
    blocks = e.blocks[e.blocks[:, 0] < k].clone()
    if len(blocks):
        blocks[-1, 1] = k
        blocks[-1, 3] = nseg
    return dataclasses.replace(
        e, vals=None if e.vals is None else _vector_storage(e.vals[:k]),
        idx=_vector_storage(e.idx[:k]), deps=e.deps[:nseg].contiguous(),
        blocks=blocks,
        max_segments=int((blocks[:, 3] - blocks[:, 2]).max())
        if len(blocks) else 0)


def _engine(case: str, op: str, device: str):
    """The walk's engine for `op` over the case's form: the planar engine
    (MULADD, ANDOR) or the tropical pass 1 (ADDMIN)."""
    graph, kw, k = CASES[case]
    cfg = EngineConfig(device=device)
    if op == "addmin":
        eng = TropicalSpMV(_layout(graph, True), TropicalSemiring, cfg).planar
    else:
        eng = PlanarSpMV(_layout(graph, False), ArithmeticSemiring
                         if op == "muladd" else LogicalSemiring, cfg)
    e = eng.entries
    values = op != "andor"
    assert (e.vals is not None) == values or op == "andor_values"
    if kw or values != (e.vals is not None):
        e = router_entries(eng, "row", **{"col_bits": e.col_bits,
                                          "values": values, **kw})
    eng.use_entries(e if k is None else _prefix(e, k))
    return eng


def _x(n: int, op: str, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if op == "addmin":        # x >= 0 with unreached FLOAT_INF entries
        x = (rng.random(n) * 100).astype(np.float32)
        x[rng.random(n) < 0.3] = TropicalSemiring.zero
    else:
        x = rng.random(n).astype(np.float32) + 0.5
        x[rng.random(n) < 0.3] = 0.0
    return x


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", list(CASES))
def test_case_form_stresses_the_walk(case, op):
    """Each case's form is what its name says, in every op's form."""
    eng = _engine(case, op, "cpu")
    e = eng.entries
    n, rows = e.idx.numel(), e.blocks.shape[0]
    assert (e.vals is None) == (op == "andor")
    if case == "empty":
        assert n == 0 and rows == 0
    elif case in ("one", "short"):
        assert 0 < n < VECTOR and rows == 1
    elif case == "ragged":
        assert n % VECTOR and rows > 1
    elif case.startswith("hub"):
        # row 0's run of 5,002 elements crosses a pass, and rows
        col, row, _ = eng.entries_index()
        run = int((row == row[0]).sum())
        assert run > 2 * VECTOR * 256
        assert int((e.blocks[:, 0] < run).sum()) > (3 if case == "hub_rows"
                                                    else 1)
    elif case == "segment_cut":
        # rows cut at BLOCK_SEGMENTS-th segment starts, off the grid of
        # ENTRIES_PER_BLOCK elements
        assert bool((e.blocks[:, 0] % ENTRIES_PER_BLOCK != 0).any())
        assert e.max_segments == BLOCK_SEGMENTS
    elif case == "big_table":
        assert 2 * 16 * e.max_segments > 48 * 1024
    elif case == "many_rows":
        assert rows > MAX_GRID
    elif case == "few_rows":
        assert 1 < rows < 132
    # every element lies in one row of the table, in order
    if rows:
        b = e.blocks.long()
        assert int(b[0, 0]) == 0 and int(b[-1, 1]) == n
        assert torch.equal(b[1:, 0], b[:-1, 1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_plain(case, op, cuda):
    """The walk against its form's plain walk: ANDOR and ADDMIN bit-equal,
    MULADD within 1e-5 of max|y|; one unpredicated launch."""
    eng = _engine(case, op, "cuda")
    xt = torch.from_numpy(_x(eng.num_cols, op)).to(cuda)
    y = eng.fused_spmv(xt)
    want = eng.fused_entries_plain(xt)
    torch.cuda.synchronize()
    assert eng.launches["fused"] == 1 and eng.launches["fused_pred"] == 0
    if op == "muladd":
        scale = max(float(want.abs().max()), 1e-30)
        assert float((y - want).abs().max()) <= 1e-5 * scale
    else:
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    if CASES[case][2] == 0:
        assert not y.any()
