"""Performance accounting (reference ``src/common/module/timer_mod.F90``).

Port of the single-device part of :mod:`cloudsc2jax.timer`: a global wall
clock and per-lane clocks, printed as the reference's table with columns/s
and MFlop/s against the nominal flop count ZHPM.  On a CUDA device each
clock reading first waits for the device (``torch.cuda.synchronize``), so a
timed region covers the work it enqueued.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List

import torch

__all__ = ["ZHPM", "PerformanceTimer"]

# Nominal flops per 100 columns (reference model constant,
# cloudsc_driver_mod.F90:58).
ZHPM = 3996006.0


@dataclasses.dataclass
class _Lane:
    """One execution lane (here: one device)."""

    lane_id: int
    t_start: float = 0.0
    t_total: float = 0.0
    calls: int = 0
    columns: int = 0


class PerformanceTimer:
    """Global + per-lane wall clocks with columns/s and MFlop/s reporting."""

    def __init__(self, device="cpu"):
        self._device = torch.device(device)
        self._lanes: Dict[int, _Lane] = {}
        self._t0 = None
        self._t1 = None

    def _now(self) -> float:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    # -- lifecycle (timer_mod.F90:56-112)
    def start(self, num_lanes: int = 1):
        self._t0 = self._now()
        for i in range(num_lanes):
            self._lanes.setdefault(i, _Lane(lane_id=i))

    def thread_start(self, lane_id: int):
        lane = self._lanes.setdefault(lane_id, _Lane(lane_id=lane_id))
        lane.t_start = self._now()

    def thread_log(self, lane_id: int, columns: int):
        lane = self._lanes[lane_id]
        lane.calls += 1
        lane.columns += columns

    def thread_end(self, lane_id: int):
        lane = self._lanes[lane_id]
        lane.t_total += self._now() - lane.t_start

    def end(self):
        self._t1 = self._now()

    @property
    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        t1 = self._t1 if self._t1 is not None else time.perf_counter()
        return t1 - self._t0

    # -- reporting (timer_mod.F90:114-174)
    def print_performance(
        self, nproma: int, ngpblks: int, ngptot: int, zhpm: float = ZHPM,
        file=None,
    ) -> float:
        """Print the perf table; returns the total columns/s."""
        file = file or sys.stderr
        print(
            f"{'NUMOMP(dev)':>12} {'NGPTOT':>10} {'#GP-cols':>10} {'#BLKS':>8}"
            f" {'NPROMA':>8} {'time(msec)':>12} {'MFlops/s':>12} {'col/s':>14}",
            file=file,
        )
        rows: List[_Lane] = sorted(self._lanes.values(), key=lambda l: l.lane_id)
        for lane in rows:
            t = max(lane.t_total, 1e-12)
            mflops = 1.0e-6 * zhpm * (lane.columns / 100.0) / t
            blks = -(-lane.columns // max(nproma, 1))
            print(
                f"{lane.lane_id:>12} {ngptot:>10} {lane.columns:>10} {blks:>8}"
                f" {nproma:>8} {1e3*t:>12.1f} {mflops:>12.0f}"
                f" {lane.columns/t:>14.0f}",
                file=file,
            )
        t = max(self.elapsed, 1e-12)
        cols = sum(l.columns for l in rows) or ngptot
        mflops = 1.0e-6 * zhpm * (cols / 100.0) / t
        print(
            f"{'total':>12} {ngptot:>10} {cols:>10} {ngpblks:>8}"
            f" {nproma:>8} {1e3*t:>12.1f} {mflops:>12.0f} {cols/t:>14.0f}",
            file=file,
        )
        return cols / t
