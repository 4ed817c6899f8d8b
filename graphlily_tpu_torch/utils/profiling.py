"""Host-side phase timing for the instrumented app runs.

Counterpart of `PhaseTimer` in `graphlily_tpu/utils/profiling.py` (the
reference's pull_push_time_breakdown): phases time the host clock around
work that ends in `sync`, `torch.cuda.synchronize` where the JAX package
calls `block_until_ready`. `dispatch_floor_ms` is the host cost of one
empty launch and its synchronize. The layout analysis (`analyze_layout`)
is not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatch_floor_ms(device: torch.device) -> float:
    """Mean host time of one empty launch (a one-element fill) and its
    sync, after a warm-up call."""
    v = torch.zeros(1, device=device)
    v.fill_(1.0)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(4):
        v.fill_(1.0)
        sync(device)
    return (time.perf_counter() - t0) / 4 * 1e3


@dataclass
class PhaseTimer:
    """Accumulating phase timer: milliseconds per phase name."""

    times_ms: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3
