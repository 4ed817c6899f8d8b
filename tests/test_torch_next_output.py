"""The fused walk's set-up output (K1 and K4 fused in MULADD:
`RouterSpMV.fused_spmv(x, out=, then=, value=)`, `glt_router_fused_next`)
and `SpMVModule.set_offset(offset, calls)` above it.

A call adds A x into `out`, an output an earlier call set up, in place of
a zeroed y, and sets `then` up to `value` in the same launch; PageRank's
pull loop so runs one launch an iteration. On the CPU the engines' plain
walk (`fused_entries_plain`) keeps the same contract, and is held here to
`spmv_coo` plus the add; every other engine and branch (the chunked
engine, the split branch, the COO engine, ANDOR, the tropical walk) adds
the offset after the SpMV, or refuses `out` and `then` by name. The
counter `next_inits` counts the calls that set up an output and is no key
of `launches`.

The card tests need a CUDA card and skip without one. Imports only torch
and the port (no jax), so on the card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_next_output.py
"""
import collections
import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphlily_tpu_torch import (ArithmeticSemiring, LogicalSemiring,
                                 TropicalSemiring, EngineConfig)
from graphlily_tpu_torch.apps import PageRank
from graphlily_tpu_torch.io import (rmat_csr, pack_router, pack_planar,
                                    pack_tropical_pass1,
                                    util_round_csr_matrix_dim)
from graphlily_tpu_torch.module import SpMVModule
from graphlily_tpu_torch.ops import (RouterSpMV, PlanarSpMV, TropicalSpMV,
                                     coo_from_csr, spmv_coo)
from graphlily_tpu_torch.ops import _build

from test_torch_fixtures import one_thread  # noqa: F401
from test_torch_fused_walk import _prefix

VALUE = 0.0123   # the set-up outputs' value, a float32 number
ENGINES = ["roll", "planar"]


@functools.cache
def _csr(engine: str):
    """RMAT graphs that the router ladder sends to the roll router (dense
    pages) and the planar router (hypersparse), rounded to 1024."""
    csr = (rmat_csr(3000, 40000, seed=5) if engine == "roll"
           else rmat_csr(12000, 60000, seed=7))
    csr = csr.copy()
    util_round_csr_matrix_dim(csr, 1024, 1024)
    return csr


@functools.cache
def _layout(engine: str):
    if engine == "roll":
        return pack_router(_csr(engine))
    return pack_planar(_csr(engine), region_rows=2048, deal="free")


def _engine(engine: str, device: str, semiring=ArithmeticSemiring):
    cls = RouterSpMV if engine == "roll" else PlanarSpMV
    return cls(_layout(engine), semiring, EngineConfig(device=device))


def _x(n: int, seed: int = 7) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.random(n).astype(np.float32) + 0.5
    x[rng.random(n) < 0.3] = 0.0
    return torch.from_numpy(x)


def _want64(engine: str, x: torch.Tensor, init: float) -> np.ndarray:
    """init + A x in float64, over the graph's rows."""
    csr = _csr(engine)
    y = np.bincount(csr.row_ids(), minlength=csr.num_rows,
                    weights=csr.adj_data[:csr.nnz].astype(np.float64)
                    * x.double().numpy()[csr.adj_indices[:csr.nnz]])
    return y + init


def _close(y: torch.Tensor, want: np.ndarray) -> None:
    """Within 1e-5 of max|want|: float32 sums in another order (float
    atomics on the card), as the walk's other tests hold MULADD."""
    err = np.abs(y.double().cpu().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max()


# ---- the plain walk's contract, on the CPU ------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
def test_plain_walk_adds_into_out_and_sets_up_then(engine):
    """out + A x, in `out`, against spmv_coo plus the add; `then` set to
    the value; one next output counted, no launch."""
    eng = _engine(engine, "cpu")
    x = _x(eng.num_cols)
    out = torch.full((eng.out_len,), 0.5, dtype=torch.float32)
    then = torch.full((eng.out_len,), float("nan"), dtype=torch.float32)
    y = eng(x, out=out, then=then, value=VALUE)
    coo = coo_from_csr(_csr(engine))
    want = spmv_coo(coo, x, ArithmeticSemiring) + 0.5
    assert y.data_ptr() == out.data_ptr() and y.numel() == eng.num_rows
    _close(y, want.double().numpy())
    _close(y, _want64(engine, x, 0.5))
    # rows past the graph's hold no element: their set-up value stays
    assert bool((out[eng.num_rows:] == 0.5).all())
    assert bool((then == np.float32(VALUE)).all())
    assert eng.next_inits == 1
    assert not any(eng.launches.values())
    assert "next_inits" not in eng.launches


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_walk_without_next_output_is_unchanged(engine):
    """`out` alone: out + A x, bit-equal to the plain walk's A x plus out
    where out is zero; nothing counted."""
    eng = _engine(engine, "cpu")
    x = _x(eng.num_cols, seed=3)
    y0 = eng(x)
    out = torch.zeros(eng.out_len, dtype=torch.float32)
    y1 = eng(x, out=out)
    assert torch.equal(y0, y1) and eng.next_inits == 0


@pytest.mark.parametrize("case", ["andor", "tropical", "split", "size",
                                  "dtype", "overlap_x", "overlap_out"])
def test_out_and_then_refused_off_the_walk(case):
    """Only a MULADD engine's fused walk takes `out` and `then`, each of
    out_len float32 elements, none overlapping another operand."""
    if case == "tropical":
        csr = _csr("planar")
        eng = TropicalSpMV(pack_tropical_pass1(csr, EngineConfig()),
                           TropicalSemiring,
                           EngineConfig(device="cpu")).planar
    else:
        eng = _engine("planar", "cpu", LogicalSemiring if case == "andor"
                      else ArithmeticSemiring)
    if case == "split":
        eng.fused = False
    n = eng.out_len
    x = _x(eng.num_cols)
    out = torch.zeros(n)
    then = torch.zeros(n)
    if case == "size":
        then = torch.zeros(n - 1)
    elif case == "dtype":
        out = torch.zeros(n, dtype=torch.float64)
    elif case == "overlap_x":
        buf = torch.zeros(2 * n)
        x, then = buf[:eng.num_cols], buf[eng.num_cols - 4:][:n]
    elif case == "overlap_out":
        then = out
    with pytest.raises(ValueError):
        eng(x, out=out, then=then, value=VALUE)
    assert eng.next_inits == 0


@pytest.mark.parametrize("engine", ["roll", "planar", "chunked", "xla"])
def test_module_apply_with_an_offset(engine):
    """`SpMVModule.set_offset(c, 3)`: every apply returns A x + c. On the
    walk (roll, planar) the first sets up its own output and each but the
    last the next one's, which the next adds into, and an apply past the
    three adds after the SpMV; the chunked and COO engines add after the
    SpMV each time. `set_offset(None)` restores today's apply."""
    walks = engine in ("roll", "planar")
    cfg = EngineConfig(device="cpu",
                       engine="auto" if engine == "chunked" else engine)
    mod = SpMVModule(cfg)
    mod.set_semiring(ArithmeticSemiring)
    graph = engine if walks else "roll"
    mod.load_and_format_matrix(_csr(graph))
    assert mod.engine_name == engine
    c = float(np.float32(VALUE))
    x = _x(mod.get_num_cols())
    plain = mod.apply(x)
    mod.set_offset(c, 3)
    ys = [x]
    for _ in range(4):
        ys.append(mod.apply(ys[-1]))
        _close(ys[-1], _want64(graph, ys[-2], c))
    assert getattr(mod.engine, "next_inits", 0) == (2 if walks else 0)
    # three results in three outputs
    assert len({y.data_ptr() for y in ys[1:4]}) == 3
    mod.set_offset(None)
    assert torch.equal(mod.apply(x), plain)


# ---- the kernel, on the card ---------------------------------------------------
def _device_ops(prof) -> collections.Counter:
    """(category, name) of every device operation in a profile, from its
    exported trace: the profiler also mirrors the host's spans on the
    device's timeline, which are no operations."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return collections.Counter(
        (e["cat"], e["name"]) for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_walk_sets_up_the_next_output(engine, cuda):
    """K1 (roll) and K4 fused (planar) with a next output: `then` holds
    the value in every element of out_len, and the set-up `out` after the
    walk is init + A x within the MULADD tolerance of float64; one launch
    of the walk, one next output counted."""
    eng = _engine(engine, "cuda")
    x = _x(eng.num_cols).to(cuda)
    out = torch.full((eng.out_len,), 0.5, device=cuda)
    then = torch.full((eng.out_len,), float("nan"), device=cuda)
    y = eng(x, out=out, then=then, value=VALUE)
    torch.cuda.synchronize()
    assert bool((then == np.float32(VALUE)).all())
    assert y.data_ptr() == out.data_ptr()
    _close(y, _want64(engine, x.cpu(), 0.5))
    assert bool((out[eng.num_rows:] == 0.5).all())
    assert eng.launches["fused"] == 1 and eng.next_inits == 1
    # against the plain walk's contract on the same inputs
    plain = torch.full((eng.out_len,), 0.5, device=cuda)
    eng.fused_entries_plain(x, out=plain)
    _close(out, plain.double().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["muladd", "andor", "addmin"])
def test_walk_without_next_output_matches_plain(op, cuda):
    """Without a next output the walk is today's: ANDOR and ADDMIN
    bit-equal to the plain walk, MULADD within 1e-5 of max|y|."""
    if op == "addmin":
        eng = TropicalSpMV(pack_tropical_pass1(_csr("planar"),
                                               EngineConfig()),
                           TropicalSemiring,
                           EngineConfig(device="cuda")).planar
    else:
        eng = _engine("planar", "cuda", ArithmeticSemiring if op == "muladd"
                      else LogicalSemiring)
    x = _x(eng.num_cols).to(cuda)
    y = eng.fused_spmv(x)
    want = eng.fused_entries_plain(x)
    torch.cuda.synchronize()
    if op == "muladd":
        _close(y, want.double().cpu().numpy())
    else:
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert eng.launches["fused"] == 1 and eng.next_inits == 0


@pytest.mark.gpu
def test_empty_form_still_sets_up_the_next_output(cuda):
    """A form with no element launches one block, for the fill alone."""
    eng = _engine("planar", "cuda")
    eng.use_entries(_prefix(eng.entries, 0))
    x = _x(eng.num_cols).to(cuda)
    out = torch.full((eng.out_len,), 0.25, device=cuda)
    then = torch.zeros(eng.out_len, device=cuda)
    y = eng(x, out=out, then=then, value=VALUE)
    torch.cuda.synchronize()
    assert bool((y == 0.25).all()) and bool((then == np.float32(VALUE)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("op", [1, 2])
def test_next_entry_point_refuses_other_semirings(op, cuda):
    """glt_router_fused_next runs MULADD only: another op is refused
    before any launch."""
    eng = _engine("planar", "cuda")
    e = eng.entries
    x = _x(eng.num_cols).to(cuda)
    y = torch.zeros(eng.out_len, device=cuda)
    then = torch.zeros(eng.out_len, device=cuda)
    with pytest.raises(RuntimeError):
        _build.launch("glt_router_fused_next", e.blocks.data_ptr(),
                      e.deps.data_ptr(), e.vals.data_ptr(), e.idx.data_ptr(),
                      x.data_ptr(), y.data_ptr(), then.data_ptr(),
                      e.blocks.shape[0], e.max_segments, e.col_bits, op,
                      then.numel(), VALUE,
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert not bool(then.any())


@pytest.mark.gpu
@pytest.mark.parametrize("iterations", [1, 10])
@pytest.mark.parametrize("engine", ENGINES)
def test_pagerank_pull_is_one_launch_an_iteration(engine, iterations, cuda):
    """A profiled `PageRank.pull(d, n, device_output=True)` on a fused
    graph launches n + 2 kernels (the initial rank, the first output's
    fill, n walks), `launches["fused"]` grows by n and `next_inits` by
    n - 1; the ranks match the float64 oracle."""
    app = PageRank(EngineConfig(engine=engine, device="cuda"))
    app.load_and_format_matrix(_csr(engine), 0.9)
    assert app.SpMV_.engine_name == engine
    app.pull(0.9, iterations, device_output=True)   # builds the kernels
    torch.cuda.synchronize()
    eng = app.SpMV_.engine
    fused, inits = eng.launches["fused"], eng.next_inits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rank = app.pull(0.9, iterations, device_output=True)
        torch.cuda.synchronize()
    ops = _device_ops(prof)
    assert sum(ops.values()) == iterations + 2, ops
    assert all(cat == "kernel" for cat, _ in ops)
    assert sum(n for (_, name), n in ops.items()
               if "router_fused_kernel" in name) == iterations
    assert eng.launches["fused"] - fused == iterations
    assert eng.next_inits - inits == iterations - 1
    want = app.compute_reference_results(0.9, iterations)
    got = app._external(rank.cpu().numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_pagerank_pull_on_the_chunked_engine_adds_after(cuda):
    """The fallback on the card: the chunked engine sets up nothing and
    matches the oracle."""
    app = PageRank(EngineConfig(engine="auto", device="cuda"))
    app.load_and_format_matrix(_csr("roll"), 0.9)
    assert app.SpMV_.engine_name == "chunked"
    rank = app.pull(0.9, 10, device_output=True)
    torch.cuda.synchronize()
    assert app.SpMV_.engine.next_inits == 0
    np.testing.assert_allclose(app._external(rank.cpu().numpy()),
                               app.compute_reference_results(0.9, 10),
                               rtol=1e-5, atol=0)
