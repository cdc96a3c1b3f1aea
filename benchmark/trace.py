"""Reading a profiler trace: the device's busy time, its idle gaps named by
what the host was doing, and the device operations by name.

The input is the Chrome trace that ``torch.profiler`` exports: complete
events (``"ph": "X"``) with ``ts`` and ``dur`` in microseconds, the
device's (kernels, copies, fills) and the host's (operators, runtime
calls, the benchmark's ``record_function`` spans) on one clock.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """The events of one traced part of a run, clipped to ``window``."""

    window: Tuple[float, float]  # (start, end), microseconds
    device: List[Tuple[float, float, str, str]] = field(default_factory=list)  # (ts, end, name, cat)
    host: List[Tuple[float, float, str]] = field(default_factory=list)  # (ts, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, merged, in order."""
        merged: List[List[float]] = []
        for ts, end, _, _ in sorted(self.device):
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took the most time, summed by name."""
        total = {}
        for ts, end, name, _ in self.device:
            total[name] = total.get(name, 0.0) + (end - ts) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest spans in which no device operation ran, each named by
        the innermost host event under way when it began."""
        edges = [self.window[0]]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self.host_at(t), d * 1e-6] for d, t in gaps[:top]]

    def host_at(self, t: float) -> str:
        inner = None
        for ts, end, name in self.host:
            if ts <= t < end and (inner is None or ts >= inner[0]):
                inner = (ts, end, name)
        return inner[2] if inner else "harness"


def read(path, window_span: str) -> Trace:
    """The trace at ``path``, clipped to the host span ``window_span`` and,
    within it, to the device's first and last operation: the traced part
    starts from a drained device and ends in a synchronise, and neither
    edge is a gap of the steady state."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == window_span
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    tr = Trace(window=(lo, hi))
    for e in events:
        ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end <= lo or ts >= hi:
            continue
        cat = e.get("cat", "").lower()
        if cat in DEVICE_CATEGORIES:
            tr.device.append((max(ts, lo), min(end, hi), e["name"], cat))
        elif cat in HOST_CATEGORIES:
            tr.host.append((ts, end, e["name"]))
    if tr.device:
        tr.window = (min(d[0] for d in tr.device), max(d[1] for d in tr.device))
    return tr
