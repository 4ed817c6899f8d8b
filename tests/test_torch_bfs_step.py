"""BFS's level step kernel (csrc/bfs_step.cu, `glt_bfs_step`) against its
plain version (ops/bfs_step.py `step_plain`), the query's initial state
(`init_state`), the engines' output without their epilogue, and the BFS
app on the card against its CPU path.

On the CPU: the plain step against a numpy step on 0/1 and count-valued
walk outputs, the initial state, the kernel's entry refusing CPU tensors,
the router and chunked engines' unclamped, unmasked output followed by
the plain step against their clamped, masked output and the dense
assign, and the app's own card branch (`level_step`), run with the
plain step written in place of the kernel, against its CPU path. On the
card (`gpu` marker; skips without one): the step bit for bit in
frontier, distance
and count (nothing fresh, everything fresh, visited entries, lengths that
are not a multiple of 4 or of a block, counts summed over many blocks),
the initial state at the first and last source with every count slot
zeroed, and `BFS.pull`, `push` and `pull_push` on the roll, planar and
chunked engines: equal to the CPU app and the oracle, one step launch an
iteration, each in an `ops.bfs.step` span, and no host-to-device copy in
a profiled query. Imports no jax, so on the card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_bfs_step.py
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphlily_tpu_torch import EngineConfig
from graphlily_tpu_torch.apps import BFS
from graphlily_tpu_torch.io import rmat_csr
from graphlily_tpu_torch.ops import _build, bfs_step

from test_torch_fixtures import one_thread
from test_torch_spans import _count_calls

CASES = ("mixed", "none", "all", "visited", "empty")
# 1 to 5 and around 1024 cut the float4s and the tail; 524,288 is s19's
# vertex count, 2,048 blocks
SIZES = (1, 3, 1024, 1027, 524288)
HOPS = 6


def _case(kind: str, n: int, seed: int = 3):
    """(y, distance, level) float32: y 0/1 or a count of frontier
    neighbours, distance 0 (unvisited) or a level. "mixed" (some fresh,
    some visited), "none" (every y 0), "all" (every distance 0, every y
    nonzero), "visited" (every distance nonzero) or "empty" (y nonzero
    only where visited)."""
    rng = np.random.default_rng(seed + n)
    y = rng.integers(0, 4, n).astype(np.float32)
    y[rng.random(n) < 0.5] = 0
    d = rng.integers(1, 9, n).astype(np.float32)
    d[rng.random(n) < 0.6] = 0
    level = np.float32(rng.integers(2, 12))
    if kind == "none":
        y[:] = 0
    elif kind == "all":
        d[:] = 0
        y = np.maximum(y, 1)
    elif kind == "visited":
        d = np.maximum(d, 1)
    elif kind == "empty":
        y = np.where(d != 0, np.maximum(y, 1), 0).astype(np.float32)
    return y, d, level


def _step_np(y, d, level):
    fresh = (y != 0) & (d == 0)
    return (fresh.astype(np.float32), np.where(fresh, level, d),
            int(fresh.sum()))


def _bits(t):
    return t.cpu().numpy().view(np.int32)


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", CASES)
def test_step_plain_matches_numpy(kind, n):
    """The plain step: frontier and distance bit for bit, the count exact,
    and its inputs left as they were."""
    y, d, level = _case(kind, n)
    yt, dt = torch.from_numpy(y.copy()), torch.from_numpy(d.copy())
    front, dist, count = bfs_step.step_plain(yt, dt, float(level))
    want_f, want_d, want_c = _step_np(y, d, level)
    np.testing.assert_array_equal(_bits(front), want_f.view(np.int32))
    np.testing.assert_array_equal(_bits(dist), want_d.view(np.int32))
    assert count.dim() == 0 and int(count) == want_c
    assert want_c == {"none": 0, "visited": 0, "empty": 0,
                      "all": n}.get(kind, want_c)
    np.testing.assert_array_equal(yt.numpy(), y)
    np.testing.assert_array_equal(dt.numpy(), d)


@pytest.mark.parametrize("n", [1, 3, 5, 1024])
@pytest.mark.parametrize("at", ["first", "last"])
def test_init_state_on_the_cpu(at, n):
    """Frontier and distance 0 but 1 at the source, contiguous and 16-byte
    aligned, 7 zeroed int32 count slots; a source outside the vertices
    raises."""
    source = 0 if at == "first" else n - 1
    cpu = torch.device("cpu")
    front, dist, counts = bfs_step.init_state(n, source, 7, torch.float32,
                                              cpu)
    want = np.zeros(n, np.float32)
    want[source] = 1
    for t in (front, dist):
        assert t.shape == (n,) and t.dtype == torch.float32
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        np.testing.assert_array_equal(t.numpy(), want)
    assert counts.dtype == torch.int32 and counts.tolist() == [0] * 7
    for bad in (n, -1):
        with pytest.raises(IndexError):
            bfs_step.init_state(n, bad, 7, torch.float32, cpu)


def test_step_refuses_cpu_tensors():
    """The kernel's entry takes card tensors only and launches nothing
    for CPU ones."""
    launches = _build.Launches("bfs", ("step",))
    y, d, level = (torch.tensor(a) for a in _case("mixed", 64))
    with pytest.raises(ValueError):
        bfs_step.step(y, d, torch.zeros((), dtype=torch.int32), level,
                      launches)
    assert launches["step"] == 0


def _app(engine: str, device: str = "cpu") -> BFS:
    app = BFS(EngineConfig(engine=engine, device=device))
    app.load_and_format_matrix(rmat_csr(3000, 40000, seed=5))
    return app


ENGINES = {"roll": "roll", "planar": "planar", "auto": "chunked"}


def test_cpu_app_keeps_the_epilogue():
    """On the CPU the modules clamp and mask and the app launches no
    step."""
    app = _app("planar")
    got = app.pull_push(3, HOPS, 0.05)
    np.testing.assert_array_equal(got,
                                  app.compute_reference_results(3, HOPS))
    assert app.SpMV_.epilogue and app.SpMSpV_.epilogue
    assert app.launches == {"step": 0}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_unclamped_walk_then_step_equals_the_epilogue(engine):
    """SpMV and SpMSpV without the epilogue, then the plain step, equal
    their clamped, masked output and the dense assign, on a frontier with
    visited vertices among its neighbours."""
    app = _app(engine)
    assert app.SpMV_.engine_name == ENGINES[engine]
    n = app.matrix_num_rows_
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.random(n) < 0.05).astype(np.float32))
    d = torch.from_numpy(np.where(rng.random(n) < 0.3,
                                  rng.integers(1, 5, n), 0)
                         .astype(np.float32))
    for module, call in ((app.SpMV_, "apply"), (app.SpMSpV_, "apply_dense")):
        want_y = getattr(module, call)(x, d)
        want_d = d.masked_fill(want_y != 0, 5.0)
        module.epilogue = False
        raw = getattr(module, call)(x, d)
        module.epilogue = True
        assert raw.shape == (n,) and raw.is_contiguous()
        assert (raw[want_y != 0] != 0).all()
        front, dist, count = bfs_step.step_plain(raw, d, 5.0)
        np.testing.assert_array_equal(front.numpy(), want_y.numpy())
        np.testing.assert_array_equal(dist.numpy(), want_d.numpy())
        assert int(count) == int((want_y != 0).sum()) > 0


def _plain_step_in_place(y, distance, count, level, launches):
    """`bfs_step.step`'s contract on CPU tensors: the plain step written
    over y and distance, its count added to the slot, one launch
    counted."""
    front, dist, fresh = bfs_step.step_plain(y, distance, level)
    with launches("step"):
        y.copy_(front)
        distance.copy_(dist)
        count.add_(fresh.to(count.dtype))
    return y, distance, count


@pytest.mark.parametrize("engine", list(ENGINES))
def test_card_branch_of_the_app_equals_its_cpu_path(engine, monkeypatch):
    """The app's own card branch (`level_step`, the modules' epilogue off,
    the count slots), run here with the plain step in place of the
    kernel: pull, push and pull_push (thresholds 0, 0.05 and 1, and no
    iterations) equal the CPU path and push as often, so pull_push reads
    each push's count from its own slot; one step an iteration."""
    app = _app(engine)
    runs = {"pull": (lambda: app.pull(3, HOPS), HOPS),
            "push": (lambda: app.push(3, HOPS), HOPS)}
    for hops in (HOPS, 1, 0):   # iteration 1 always pushes
        for th in (0.0, 0.05, 1.0):
            runs[f"pull_push {hops} {th}"] = (
                lambda hops=hops, th=th: app.pull_push(3, hops, th),
                max(hops, 1))
    pushes = _count_calls(monkeypatch, app.SpMSpV_, "apply_dense")
    want = {}
    for label, (run, _) in runs.items():
        before = pushes[0]
        want[label] = run(), pushes[0] - before
    assert app.launches["step"] == 0
    monkeypatch.setattr(bfs_step, "step", _plain_step_in_place)
    app.level_step = True
    app.SpMV_.epilogue = app.SpMSpV_.epilogue = False
    for label, (run, iterations) in runs.items():
        before, launched = pushes[0], app.launches["step"]
        got = run()
        np.testing.assert_array_equal(got, want[label][0], err_msg=label)
        assert pushes[0] - before == want[label][1], label
        assert app.launches["step"] - launched == iterations, label
    assert 1 < want[f"pull_push {HOPS} 0.05"][1] < HOPS


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [*SIZES, 2500003])
@pytest.mark.parametrize("kind", CASES)
def test_step_kernel_matches_plain(kind, n, cuda):
    """One launch: frontier (over y, in place) and distance bit-equal to
    the plain step, the count added to its slot alone."""
    y, d, level = _case(kind, n)
    want_f, want_d, want_c = bfs_step.step_plain(
        torch.from_numpy(y), torch.from_numpy(d), float(level))
    yt, dt = torch.from_numpy(y).to(cuda), torch.from_numpy(d).to(cuda)
    counts = torch.zeros(3, dtype=torch.int32, device=cuda)
    launches = _build.Launches("bfs", ("step",))
    front, dist, count = bfs_step.step(yt, dt, counts[1], float(level),
                                       launches)
    torch.cuda.synchronize()
    assert front is yt and dist is dt and launches["step"] == 1
    np.testing.assert_array_equal(_bits(front), _bits(want_f))
    np.testing.assert_array_equal(_bits(dist), _bits(want_d))
    assert int(count) == int(want_c)
    assert counts.tolist() == [0, int(want_c), 0]


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [0, 1, 11])
@pytest.mark.parametrize("n", [1, 3, 1024, 524288])
@pytest.mark.parametrize("at", ["first", "last"])
def test_init_state_on_the_card(at, n, slots, cuda):
    """On the card: both vectors 0 but 1 at the source, 16-byte aligned,
    every count slot 0."""
    source = 0 if at == "first" else n - 1
    front, dist, counts = bfs_step.init_state(n, source, slots,
                                              torch.float32, cuda)
    torch.cuda.synchronize()
    want = np.zeros(n, np.float32)
    want[source] = 1
    for t in (front, dist):
        assert t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0
        np.testing.assert_array_equal(t.cpu().numpy(), want)
    assert counts.is_cuda and counts.dtype == torch.int32
    assert counts.tolist() == [0] * slots


@pytest.mark.gpu
@pytest.mark.parametrize("engine", list(ENGINES))
def test_bfs_app_on_the_card(engine, cuda):
    """pull, push and pull_push (thresholds 0, 0.05, 1) equal the CPU app
    and the oracle; the modules skip their epilogue; one step launch an
    iteration."""
    app, cpu_app = _app(engine, "cuda"), _app(engine)
    assert app.SpMV_.engine_name == ENGINES[engine]
    assert not (app.SpMV_.epilogue or app.SpMSpV_.epilogue)
    for src in (0, 17):
        want = app.compute_reference_results(src, HOPS)
        runs = {"pull": (lambda: app.pull(src, HOPS),
                         cpu_app.pull(src, HOPS)),
                "push": (lambda: app.push(src, HOPS),
                         cpu_app.push(src, HOPS))}
        for th in (0.0, 0.05, 1.0):
            runs[f"pull_push {th}"] = (
                lambda th=th: app.pull_push(src, HOPS, th),
                cpu_app.pull_push(src, HOPS, th))
        for label, (run, cpu_got) in runs.items():
            before = app.launches["step"]
            got = run()
            np.testing.assert_array_equal(got, cpu_got, err_msg=label)
            np.testing.assert_array_equal(got, want, err_msg=label)
            assert app.launches["step"] - before == HOPS, label
        assert 1 < (want != 0).sum() < app.matrix_num_rows_


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["roll", "planar"])
def test_profiled_query_copies_nothing_to_the_card(engine, cuda,
                                                   monkeypatch):
    """A profiled pull_push: no host-to-device copy among its device ops,
    the step kernel on the device, no `router.epilogue` span, and each
    `ops.bfs.step` span one count of `launches["step"]`."""
    app = _app(engine, "cuda")
    app.pull_push(0, HOPS, 0.05, device_output=True)   # builds the kernels
    torch.cuda.synchronize()
    pushes = _count_calls(monkeypatch, app.SpMSpV_, "apply_dense")
    before = dict(app.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        app.pull_push(0, HOPS, 0.05, device_output=True)
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events())
    assert not [n for n in names if "HtoD" in n]
    assert any("bfs_step_kernel" in n for n in names)
    grew = {k: v - before[k] for k, v in app.launches.items()}
    assert grew == {"step": HOPS} and 1 <= pushes[0] < HOPS
    host = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU)
    assert host["ops.bfs.step"] == HOPS
    assert host["bfs.assign"] == HOPS and host["router.epilogue"] == 0
