"""SSSP's push-step relax and initial state: the wrapper of
csrc/sssp_relax.cu and its plain PyTorch version.

With y = A (min,+) frontier from the SpMSpV module, a push step relaxes:
improved = y < distance (strict, float32: ties and INF stay), the
distance takes y where improved, the new frontier is y there and INF
elsewhere, and its nnz is the improved count. `relax` runs that as one
launch of `glt_sssp_relax`, in place (the frontier over y), adding the
count to a zeroed int32 slot on the card, and counts the launch in the
caller's `launches["relax"]`, inside the span `ops.sssp.relax`;
`relax_plain` serves CPU tensors. Compare and select are exact in
float32, so the two agree bit for bit. `init_state` writes a query's
initial distance and zeroed count slots, one per push step, on the
engines' device: no host vector is filled and nothing is copied.
"""
from __future__ import annotations

import torch

from ..semiring import TropicalSemiring
from . import _build

INF = TropicalSemiring.zero


def init_state(n: int, source: int, slots: int, dtype: torch.dtype,
               device: torch.device):
    """(distance, count slots) on `device`: the distance INF but 0 at
    `source`, and `slots` zeroed int32 count slots."""
    if not 0 <= source < n:
        raise IndexError(f"source {source} out of range for {n} vertices")
    d = torch.full((n,), INF, dtype=dtype, device=device)
    d.narrow(0, source, 1).fill_(0)
    return d, torch.zeros(slots, dtype=torch.int32, device=device)


def relax_plain(y: torch.Tensor, distance: torch.Tensor):
    """(distance, new frontier, improved count as a 0-dim tensor), as new
    tensors."""
    improved = y < distance
    return (torch.where(improved, y, distance),
            torch.where(improved, y, INF), improved.sum())


def relax(y: torch.Tensor, distance: torch.Tensor, count: torch.Tensor,
          launches: _build.Launches):
    """`relax_plain` on the card, one launch of glt_sssp_relax: distance
    and y (the new frontier) are updated in place and the improved count
    is added to `count`, a zeroed int32 slot. Returns (distance, y,
    count)."""
    n = distance.numel()
    for name, t in (("y", y), ("distance", distance)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != n or t.device != count.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: need {n} contiguous, 16-byte aligned "
                             f"float32 on {count.device}")
    if count.dtype != torch.int32 or not count.is_cuda:
        raise ValueError("count: need an int32 slot on the card")
    with launches("relax"):
        _build.launch("glt_sssp_relax", y.data_ptr(), distance.data_ptr(),
                      count.data_ptr(), n, INF,
                      torch.cuda.current_stream(count.device).cuda_stream)
    return distance, y, count
