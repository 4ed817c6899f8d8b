"""BFS's level step and initial state: the wrapper of csrc/bfs_step.cu and
its plain PyTorch version.

With y the output of iteration `it`'s ANDOR walk (SpMV or SpMSpV over the
frontier) before its 0/1 clamp and its WRITE_TO_ZERO mask, the level
step clamps and masks against the distances, stamps the level it + 1:
new = y != 0 and distance == 0; the next frontier is new as 0/1, the
distance takes the level where new, and the frontier's nnz is new's
count. A y already clamped and masked gives the same answer. `step` runs
that as one launch of `glt_bfs_step`, in place (the frontier over y),
adding the count to a zeroed int32 slot on the card, and counts the
launch in the caller's `launches["step"]`, inside the span
`ops.bfs.step`; `step_plain` serves CPU tensors. Compare and select are
exact in float32 (0/1 and small whole levels), so the two agree bit for
bit. `init_state` writes a query's initial frontier and distance and its
zeroed count slots on the engines' device: no host vector is filled and
nothing is copied.
"""
from __future__ import annotations

import torch

from . import _build


def init_state(n: int, source: int, slots: int, dtype: torch.dtype,
               device: torch.device):
    """(frontier, distance, count slots) on `device`: both vectors 0 but 1
    at `source`, and `slots` zeroed int32 count slots. The two vectors are
    the rows of one zeroed buffer, each row's start 16-byte aligned, whose
    source column one fill sets: three launches in all."""
    if not 0 <= source < n:
        raise IndexError(f"source {source} out of range for {n} vertices")
    state = torch.zeros((2, -(-n // 4) * 4), dtype=dtype, device=device)
    state.narrow(1, source, 1).fill_(1)
    frontier, distance = state[:, :n].unbind(0)
    return frontier, distance, torch.zeros(slots, dtype=torch.int32,
                                           device=device)


def step_plain(y: torch.Tensor, distance: torch.Tensor, level: float):
    """(next frontier, distance, its count as a 0-dim tensor), as new
    tensors."""
    fresh = (y != 0) & (distance == 0)
    return (fresh.to(y.dtype), distance.masked_fill(fresh, level),
            fresh.sum())


def step(y: torch.Tensor, distance: torch.Tensor, count: torch.Tensor,
         level: float, launches: _build.Launches):
    """`step_plain` on the card, one launch of glt_bfs_step: y (the next
    frontier) and distance are updated in place and the count is added to
    `count`, a zeroed int32 slot. Returns (y, distance, count)."""
    n = distance.numel()
    for name, t in (("y", y), ("distance", distance)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != n or t.device != count.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: need {n} contiguous, 16-byte aligned "
                             f"float32 on {count.device}")
    if count.dtype != torch.int32 or not count.is_cuda:
        raise ValueError("count: need an int32 slot on the card")
    with launches("step"):
        _build.launch("glt_bfs_step", y.data_ptr(), distance.data_ptr(),
                      count.data_ptr(), n, float(level),
                      torch.cuda.current_stream(count.device).cuda_stream)
    return y, distance, count
