"""Reduces a profiler trace of the window's traced slice to what the
per-layer readers need.

The trace is `torch.profiler`'s Chrome-trace export (CPU and CUDA
activities). Device operations are its `kernel`, `gpu_memcpy` and
`gpu_memset` events; each carries the `correlation` id of the runtime
call that launched it (`cuda_runtime` / `cuda_driver` events, on the
host's timeline). Spans are the harness's `record_function` annotations
(`user_annotation` events): `bench.query` around each query's call,
`bench.sync` around the harness's wait for its answer, and one per
wrapped module entry. A device operation belongs to a span when its
launch call lies inside that span. Times in the trace are microseconds.
"""
from __future__ import annotations

import bisect
import collections
import json

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host calls that wait for the device
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuCtxSynchronize",
              "cuStreamSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")
QUERY_SPAN = "bench.query"
SYNC_SPAN = "bench.sync"


class Intervals:
    """Sorted, possibly overlapping [start, end] intervals; membership of
    a point by binary search over their merged union."""

    def __init__(self, spans):
        merged = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.merged = merged

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.merged[i][1]

    def total(self) -> float:
        return sum(e - s for s, e in self.merged)


class Trace:
    """The traced slice: from the first traced query's start to the end
    of the last traced query's wait."""

    def __init__(self, events: list):
        x = [e for e in events if e.get("ph") == "X" and "ts" in e]
        for e in x:
            e["ts"] = float(e["ts"])
            e["end"] = e["ts"] + float(e.get("dur", 0.0))
        ann = [e for e in x if e.get("cat") == "user_annotation"]
        queries = sorted(e["ts"] for e in ann if e["name"] == QUERY_SPAN)
        syncs = [e for e in ann if e["name"] == SYNC_SPAN]
        self.queries = len(queries)
        if not queries or not syncs:
            self.t0 = self.t1 = 0.0
        else:
            self.t0 = queries[0]
            self.t1 = max(e["end"] for e in syncs)
        inside = [e for e in x if e["ts"] >= self.t0 and e["end"] <= self.t1]
        self.gpu = [e for e in inside if e.get("cat") in GPU_CATS]
        self.launch = [e for e in inside if e.get("cat") in LAUNCH_CATS]
        self.host = [e for e in inside if e.get("cat") in
                     ("cpu_op", "user_annotation", "cuda_runtime",
                      "cuda_driver", "python_function")]
        self.spans = collections.defaultdict(list)
        for e in ann:
            self.spans[e["name"]].append((e["ts"], e["end"]))
        self.launch_ts = {e["args"]["correlation"]: e["ts"]
                          for e in self.launch
                          if "correlation" in e.get("args", {})}

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> list:
        return [e for e in self.gpu if e.get("cat") == "kernel"]

    def busy_us(self) -> float:
        """The union of the device operations' intervals in the slice."""
        return Intervals((e["ts"], e["end"]) for e in self.gpu).total()

    def attributed(self) -> float:
        """The share of device operations whose launch call is in the
        trace; the rest cannot be placed in a span."""
        if not self.gpu:
            return 0.0
        hit = sum(1 for e in self.gpu
                  if e.get("args", {}).get("correlation") in self.launch_ts)
        return hit / len(self.gpu)

    def under(self, span: str) -> tuple:
        """(device microseconds, number of spans) of the device operations
        launched inside spans named `span`."""
        spans = self.spans.get(span, [])
        spans = [(s, e) for s, e in spans if s >= self.t0 and e <= self.t1]
        if not spans:
            return 0.0, 0
        inside = Intervals(spans)
        us = 0.0
        for e in self.gpu:
            t = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if t is not None and t in inside:
                us += e["end"] - e["ts"]
        return us, len(spans)

    def syncs(self) -> int:
        """Host calls that waited for the device, outside the harness's own
        wait for each answer."""
        own = Intervals(s for s in self.spans.get(SYNC_SPAN, []))
        return sum(1 for e in self.launch
                   if e["name"] in SYNC_CALLS and e["ts"] not in own)

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot = collections.Counter()
        for e in self.gpu:
            tot[e["name"]] += (e["end"] - e["ts"]) * 1e-6
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """[host activity, seconds] of the device's idle gaps in the slice,
        summed by the innermost host event under each gap's midpoint."""
        busy = Intervals((e["ts"], e["end"]) for e in self.gpu).merged
        edges = [self.t0] + [t for s, e in busy for t in (s, e)] + [self.t1]
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        tot = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "host between calls"
            i = bisect.bisect_right(starts, mid)
            # the covering event that started last is the innermost
            for e in reversed(host[max(0, i - 400):i]):
                if e["end"] >= mid:
                    name = e["name"]
                    break
            tot[name] += (b - a) * 1e-6
        return [[n, s] for n, s in tot.most_common(k)]
