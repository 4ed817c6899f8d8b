"""SSSP's push-step relax kernel (csrc/sssp_relax.cu, `glt_sssp_relax`)
against its plain version (ops/sssp_relax.py `relax_plain`), the query's
initial state (`init_state`), and the SSSP app on the card against its
CPU path and the float64 oracle.

On the CPU: the plain relax against a numpy relax on the same cases, the
initial state, and the kernel's entry refusing CPU tensors. On the card
(`gpu` marker; skips without one): the relax bit for bit in distance,
frontier and count (no entry improved, every entry improved, ties, INF on
either side, lengths that are not a multiple of 4 or of a block, counts
summed over many blocks), the initial state at the first and last source
with every count slot zeroed, and `SSSP.push` / `pull_push` on a small
chunked and a small tropical graph: equal to the CPU app and the oracle,
one relax launch a push step, each in an `ops.sssp.relax` span, and no
host-to-device copy in a profiled query. Imports no jax, so on the card
it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_sssp_relax.py
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphlily_tpu_torch import EngineConfig
from graphlily_tpu_torch.apps import SSSP
from graphlily_tpu_torch.io import rmat_csr
from graphlily_tpu_torch.ops import _build, sssp_relax

from test_torch_fixtures import one_thread
from test_torch_spans import _count_calls

INF = np.float32(sssp_relax.INF)
CASES = ("mixed", "none", "all", "ties", "inf")
# 1 to 5 and around 1024 cut the float4s and the tail; 262,147 is 256
# blocks and a tail; 2,500,003 outgrows the grid, so blocks loop
SIZES = (1, 3, 4, 5, 1023, 1025, 262147)


def _case(kind: str, n: int, seed: int = 3):
    """(y, distance) float32: "mixed" (some improved, some ties, INF on
    both sides), "none" (y >= distance, ties included), "all" (distance
    INF, y finite), "ties" (y == distance) or "inf" (y all INF)."""
    rng = np.random.default_rng(seed + n)
    d = (rng.random(n) * 10).astype(np.float32)
    d[rng.random(n) < 0.3] = INF
    y = (rng.random(n) * 10).astype(np.float32)
    y[rng.random(n) < 0.3] = INF
    if kind == "mixed":
        y[::7] = d[::7]
    elif kind == "none":
        y = np.maximum(y, d)
    elif kind == "all":
        d[:] = INF
        y = np.minimum(y, np.float32(100))
    elif kind == "ties":
        y = d.copy()
    elif kind == "inf":
        y[:] = INF
    return y, d


def _relax_np(y, d):
    improved = y < d
    return (np.where(improved, y, d), np.where(improved, y, INF),
            int(improved.sum()))


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES[:6])
@pytest.mark.parametrize("kind", CASES)
def test_relax_plain_matches_numpy(kind, n):
    """The plain relax: distance and frontier bit for bit, the count exact,
    and its inputs left as they were."""
    y, d = _case(kind, n)
    yt, dt = torch.from_numpy(y.copy()), torch.from_numpy(d.copy())
    dist, front, count = sssp_relax.relax_plain(yt, dt)
    want_d, want_f, want_c = _relax_np(y, d)
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  want_d.view(np.int32))
    np.testing.assert_array_equal(front.numpy().view(np.int32),
                                  want_f.view(np.int32))
    assert count.dim() == 0 and int(count) == want_c
    assert want_c == {"none": 0, "ties": 0, "inf": 0, "all": n}.get(kind,
                                                                     want_c)
    np.testing.assert_array_equal(yt.numpy(), y)
    np.testing.assert_array_equal(dt.numpy(), d)


@pytest.mark.parametrize("n", [1, 5, 1024])
@pytest.mark.parametrize("at", ["first", "last"])
def test_init_state_on_the_cpu(at, n):
    """INF but 0 at the source, 7 zeroed int32 count slots; a source
    outside the vertices raises."""
    source = 0 if at == "first" else n - 1
    cpu = torch.device("cpu")
    d, counts = sssp_relax.init_state(n, source, 7, torch.float32, cpu)
    want = np.full(n, INF, np.float32)
    want[source] = 0
    np.testing.assert_array_equal(d.numpy(), want)
    assert counts.dtype == torch.int32 and counts.tolist() == [0] * 7
    for bad in (n, -1):
        with pytest.raises(IndexError):
            sssp_relax.init_state(n, bad, 7, torch.float32, cpu)


def test_relax_refuses_cpu_tensors():
    """The kernel's entry takes card tensors only and launches nothing
    for CPU ones."""
    launches = _build.Launches("sssp", ("relax",))
    y, d = (torch.from_numpy(a) for a in _case("mixed", 64))
    with pytest.raises(ValueError):
        sssp_relax.relax(y, d, torch.zeros((), dtype=torch.int32), launches)
    assert launches["relax"] == 0


def test_cpu_app_launches_no_kernel():
    """On the CPU the app takes the plain versions: its counters stay 0."""
    app = SSSP(EngineConfig(device="cpu"))
    app.load_and_format_matrix(rmat_csr(3000, 40000, seed=5))
    got = app.pull_push(3, 6, 0.05)
    np.testing.assert_array_equal(got, app.compute_reference_results(3, 6))
    assert app.push(3, 2).dtype == np.float32
    assert app.launches == {"relax": 0}


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.cpu().numpy().view(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [*SIZES, 2500003])
@pytest.mark.parametrize("kind", CASES)
def test_relax_kernel_matches_plain(kind, n, cuda):
    """One launch: distance and frontier (over y, in place) bit-equal to
    the plain relax, the improved count added to its slot alone."""
    y, d = _case(kind, n)
    want_d, want_f, want_c = sssp_relax.relax_plain(torch.from_numpy(y),
                                              torch.from_numpy(d))
    yt, dt = torch.from_numpy(y).to(cuda), torch.from_numpy(d).to(cuda)
    counts = torch.zeros(3, dtype=torch.int32, device=cuda)
    launches = _build.Launches("sssp", ("relax",))
    dist, front, count = sssp_relax.relax(yt, dt, counts[1], launches)
    torch.cuda.synchronize()
    assert dist is dt and front is yt and launches["relax"] == 1
    np.testing.assert_array_equal(_bits(dist), want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(_bits(front),
                                  want_f.numpy().view(np.int32))
    assert int(count) == int(want_c)
    assert counts.tolist() == [0, int(want_c), 0]


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [0, 1, 7])
@pytest.mark.parametrize("n", [1, 5, 1024, 262147])
@pytest.mark.parametrize("at", ["first", "last"])
def test_init_state_on_the_card(at, n, slots, cuda):
    """On the card: INF everywhere but 0 at the source, every count slot
    0, equal to the host's."""
    source = 0 if at == "first" else n - 1
    d, counts = sssp_relax.init_state(n, source, slots, torch.float32, cuda)
    torch.cuda.synchronize()
    want = np.full(n, INF, np.float32)
    want[source] = 0
    assert d.is_cuda and counts.is_cuda
    np.testing.assert_array_equal(d.cpu().numpy(), want)
    assert counts.dtype == torch.int32 and counts.tolist() == [0] * slots


def _apps(engine, weighted):
    """(card app, CPU app) on one graph: "auto" packs the chunked engine,
    "router" the tropical one."""
    graphs = {"auto": lambda: rmat_csr(3000, 40000, seed=5),
              "router": lambda: rmat_csr(3000, 20000, seed=3)}
    apps = []
    for device in ("cuda", "cpu"):
        app = SSSP(EngineConfig(engine=engine, device=device))
        app.load_and_format_matrix(graphs[engine](),
                                   unit_weights=not weighted)
        apps.append(app)
    assert apps[0].SpMSpV_.engine_name == {"auto": "chunked",
                                           "router": "tropical"}[engine]
    return apps


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("engine", ["auto", "router"],
                         ids=["chunked", "tropical"])
def test_sssp_app_on_the_card(engine, weighted, cuda, monkeypatch):
    """push and pull_push (thresholds 0, 0.05, 1) equal the CPU app bit for
    bit and the oracle (exactly on unit weights); one relax launch a push
    step."""
    app, cpu_app = _apps(engine, weighted)
    pushes = _count_calls(monkeypatch, app.SpMSpV_, "apply_dense")
    for src in (0, 17):
        want = app.compute_reference_results(src, 6)
        runs = {"push": (lambda: app.push(src, 6), cpu_app.push(src, 6))}
        for th in (0.0, 0.05, 1.0):
            runs[f"pull_push {th}"] = (
                lambda th=th: app.pull_push(src, 6, th),
                cpu_app.pull_push(src, 6, th))
        runs["pull"] = (lambda: app.pull(src, 6), cpu_app.pull(src, 6))
        for label, (run, cpu_got) in runs.items():
            before, pushes[0] = dict(app.launches), 0
            got = run()
            np.testing.assert_array_equal(got, cpu_got, err_msg=label)
            if weighted:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=label)
            else:
                np.testing.assert_array_equal(got, want, err_msg=label)
            assert app.launches["relax"] - before["relax"] == pushes[0]
        assert 1 < (want < INF).sum() < app.matrix_num_rows_


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["auto", "router"],
                         ids=["chunked", "tropical"])
def test_profiled_query_copies_nothing_to_the_card(engine, cuda):
    """A profiled pull_push: no host-to-device copy among its device ops,
    the relax kernel on the device, and each `ops.sssp.relax` span one
    count of `launches["relax"]`."""
    app, _ = _apps(engine, True)
    app.pull_push(0, 6, 0.05, device_output=True)   # builds the kernels
    torch.cuda.synchronize()
    before = dict(app.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        app.pull_push(0, 6, 0.05, device_output=True)
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events())
    assert not [n for n in names if "HtoD" in n]
    assert any("sssp_relax_kernel" in n for n in names)
    grew = {k: v - before[k] for k, v in app.launches.items()}
    assert grew["relax"] >= 1
    # the host's spans; the profiler mirrors each on the device's timeline
    host = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU)
    assert {k: host[f"ops.sssp.{k}"] for k in grew} == grew
