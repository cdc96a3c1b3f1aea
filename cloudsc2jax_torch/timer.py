"""Performance accounting and energy monitoring (reference
``src/common/module/timer_mod.F90`` and ``ec_pmon_mod.F90``).

Port of :mod:`cloudsc2jax.timer`: a global wall clock and per-lane clocks,
printed as the reference's table with columns/s and MFlop/s against the
nominal flop count ZHPM.  On CUDA lanes each clock reading first waits for
every lane's card (``torch.cuda.synchronize``), so a timed region covers the
work it enqueued.  A lane is a device of the column mesh; its ``core_id`` is
the card's index, or for a CPU lane the core the process runs on
(``sched_getcpu`` of the native shim, :mod:`cloudsc2jax_torch.native`; the
reference's core id).  The lanes of one process run
one region together, so their clocks are lane 0's copied (``mirror``
rows) unless :meth:`PerformanceTimer.measure_device_lanes` re-times each
lane's share on its own card with CUDA events (``measured`` rows).  With a
process group, ``print_performance(gather=True)`` gathers every rank's
records to rank 0, which prints rank rows, a ``TOTAL @ rank#N`` row per rank
and a grand total (the MPI_GATHER of timer_mod.F90:124-171).  With
``EC_PMON=1`` the host's energy counter is read at the start and printed
after the table (:func:`energy_probe`, the native shim's reading first).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as tdist

__all__ = ["ZHPM", "PerformanceTimer", "energy_probe"]

# Nominal flops per 100 columns (reference model constant,
# cloudsc_driver_mod.F90:58).
ZHPM = 3996006.0


# The counters energy_probe reads, in its order: Cray's pm_counters, which
# the reference reads (ec_pmon_mod.F90:14-56), then Linux's RAPL powercap.
CRAY_ENERGY = "/sys/cray/pm_counters/energy"
CRAY_POWER = "/sys/cray/pm_counters/power"
RAPL_ENERGY_UJ = "/sys/class/powercap/intel-rapl:0/energy_uj"


def _read_first(path) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def energy_probe() -> Optional[Dict[str, float]]:
    """The host's energy counter when ``EC_PMON=1`` (``cloudsc2jax/timer.py:
    40-68``): the native shim's ``energy_uj`` first (power not available:
    NaN), then ``{"energy_j", "power_w"}`` from Cray's pm_counters, else from
    RAPL (power NaN); ``None`` when not requested or when no counter can be
    read."""
    if os.environ.get("EC_PMON") != "1":
        return None
    from .native import hostinfo

    uj = hostinfo.energy_uj()
    if uj > 0:
        return {"energy_j": uj * 1e-6, "power_w": float("nan")}
    cray_e = _read_first(CRAY_ENERGY)
    if cray_e is not None:
        cray_p = _read_first(CRAY_POWER)
        return {
            "energy_j": float(cray_e.split()[0]),
            "power_w": float(cray_p.split()[0]) if cray_p else float("nan"),
        }
    rapl = _read_first(RAPL_ENERGY_UJ)
    if rapl is not None:
        return {"energy_j": float(rapl) * 1e-6, "power_w": float("nan")}
    return None


def _core_of(device: Optional[torch.device]) -> int:
    """A card's index, or ``sched_getcpu`` for the host (timer_mod.F90:93's
    core id, ``cloudsc2jax/timer.py:104-110``)."""
    if device is not None and device.type == "cuda":
        return device.index
    from .native import hostinfo

    return hostinfo.sched_getcpu()


@dataclasses.dataclass
class _Lane:
    """One execution lane (one device of the mesh)."""

    lane_id: int
    core_id: int = -1
    t_start: float = 0.0
    t_total: float = 0.0
    calls: int = 0
    columns: int = 0
    # the wall time is lane 0's, copied: the lanes ran one region together
    mirrored: bool = False
    # the wall time is this lane's own, re-timed on its card
    # (measure_device_lanes)
    measured_lane: bool = False


class PerformanceTimer:
    """Global + per-lane wall clocks with columns/s and MFlop/s reporting.
    ``device`` is one device or the mesh's lanes; every clock reading waits
    for each CUDA one."""

    def __init__(self, device="cpu"):
        devices = [device] if isinstance(device, (str, torch.device)) else device
        self._devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self._lanes: Dict[int, _Lane] = {}
        self._t0 = None
        self._t1 = None
        self._energy0 = None

    def _now(self) -> float:
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return time.perf_counter()

    def _lane(self, lane_id: int) -> _Lane:
        lane = self._lanes.get(lane_id)
        if lane is None:
            lane = self._lanes[lane_id] = _Lane(lane_id=lane_id,
                                                core_id=self._core_id(lane_id))
        return lane

    def _core_id(self, lane_id: int) -> int:
        """The card's index of a lane; for a CPU lane the core this process
        runs on (-1 where the native shim cannot say)."""
        dev = self._devices[lane_id] if lane_id < len(self._devices) else None
        return _core_of(dev)

    # -- lifecycle (timer_mod.F90:56-112)
    def start(self, num_lanes: int = 1):
        self._energy0 = energy_probe()
        self._t0 = self._now()
        for i in range(num_lanes):
            self._lane(i)

    def thread_start(self, lane_id: int):
        self._lane(lane_id).t_start = self._now()

    def thread_log(self, lane_id: int, columns: int):
        lane = self._lanes[lane_id]
        lane.calls += 1
        lane.columns += columns

    def thread_end(self, lane_id: int):
        lane = self._lanes[lane_id]
        lane.t_total += self._now() - lane.t_start

    # -- the lanes of one process run one timed region together (≙ the
    # per-thread rows of timer_mod.F90:124-171, with devices as lanes)
    def spmd_log(self, num_lanes: int, columns: int):
        """Attribute one region's ``columns`` to ``num_lanes`` lanes: split
        evenly, the remainder to lane 0."""
        per = columns // max(num_lanes, 1)
        rem = columns - per * num_lanes
        for d in range(num_lanes):
            lane = self._lane(d)
            lane.calls += 1
            lane.columns += per + (rem if d == 0 else 0)

    def mirror_times(self, num_lanes: int):
        """Copy lane 0's closed wall time to lanes 1..``num_lanes``-1: the
        best estimate of each lane's time, not a measurement of it, so the
        rows print ``(mirror)``."""
        t = self._lanes[0].t_total
        for d in range(1, num_lanes):
            lane = self._lane(d)
            lane.t_total = t
            lane.mirrored = True

    def measure_device_lanes(self, step_fn: Callable, per_lane: Sequence,
                             repeats: int = 2, calls_equivalent: int = 1):
        """Replace the lanes' clocks with MEASURED ones
        (``cloudsc2jax/timer.py:154-207``): each lane's inputs
        ``per_lane[l]`` run through ``step_fn`` on the lane's own device,
        one lane after the other, warmed up once and then timed over
        ``repeats`` calls (CUDA events on a card, the host's clock on the
        CPU).  A re-run of each share, not a decomposition of the shared
        region: a slow card shows.  ``calls_equivalent`` (the CLI's
        ``--repeat``) scales the time to the calls the lane's columns
        count.  Rows print ``(measured)``; in a process group each rank
        measures its own lanes and the flag rides through the gather."""
        for lane_id, x in enumerate(per_lane):
            dev = x.pt.device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                step_fn(x)  # warm
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(repeats):
                        step_fn(x)
                    stop.record()
                    stop.synchronize()
                    t = start.elapsed_time(stop) * 1e-3 / repeats
                else:
                    t0 = time.perf_counter()
                    for _ in range(repeats):
                        step_fn(x)
                    t = (time.perf_counter() - t0) / repeats
            lane = self._lane(lane_id)
            lane.t_total = t * max(calls_equivalent, 1)
            lane.core_id = _core_of(dev)
            lane.mirrored = False
            lane.measured_lane = True

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
        file=None, gather: bool = False,
    ) -> float:
        """Print the perf table; returns the total columns/s.  ``gather=True``
        in a process group is a collective: every rank's records go to rank
        0, which prints per-rank rows, per-rank totals and a grand total
        (:meth:`_print_gathered`); the other ranks print nothing and return
        their own rate."""
        file = file or sys.stderr
        if gather and tdist.is_initialized() and tdist.get_world_size() > 1:
            return self._print_gathered(nproma, ngpblks, ngptot, zhpm, file)
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
                f" {lane.columns/t:>14.0f}{_tag(lane.measured_lane, lane.mirrored)}",
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
        e1 = energy_probe()
        if self._energy0 is not None and e1 is not None:
            de = e1["energy_j"] - self._energy0["energy_j"]
            print(f"EC_PMON: energy={de:.1f} J over {t:.3f}s", file=file)
        return cols / t

    def _gather_records(self, zhpm: float) -> torch.Tensor:
        """All-gather every rank's lane records and its summary
        (``cloudsc2jax/timer.py:268-301``; the ISENDBUF/IRECVBUF exchange,
        timer_mod.F90:128-155).  A collective: every rank calls it.  One
        float64 tensor per rank, ``(nlanes_max + 1, 8)``: rows ``[lane_id,
        core_id, columns, calls, t_ms, mflops, mirrored, measured]``, padded
        with zero rows to the largest lane count, then ``[-1, rank,
        total_columns, total_calls, elapsed_ms, mflops, 0, 0]``.  Returns
        ``(nproc, nlanes_max + 1, 8)``."""
        lanes = sorted(self._lanes.values(), key=lambda l: l.lane_id)
        n = torch.tensor([len(lanes)], dtype=torch.int64)
        tdist.all_reduce(n, op=tdist.ReduceOp.MAX)
        nlmax = int(n)
        buf = torch.zeros((nlmax + 1, 8), dtype=torch.float64)
        for i, lane in enumerate(lanes):
            t = max(lane.t_total, 1e-12)
            buf[i] = torch.tensor([
                lane.lane_id, lane.core_id, lane.columns, lane.calls, 1e3 * t,
                1.0e-6 * zhpm * (lane.columns / 100.0) / t,
                float(lane.mirrored), float(lane.measured_lane)],
                dtype=torch.float64)
        elapsed = max(self.elapsed, 1e-12)
        cols = sum(l.columns for l in lanes)
        buf[nlmax] = torch.tensor([
            -1, tdist.get_rank(), cols, sum(l.calls for l in lanes),
            1e3 * elapsed, 1.0e-6 * zhpm * (cols / 100.0) / elapsed, 0.0, 0.0],
            dtype=torch.float64)
        out = [torch.empty_like(buf) for _ in range(tdist.get_world_size())]
        tdist.all_gather(out, buf)
        return torch.stack(out)

    def _print_gathered(self, nproma, ngpblks, ngptot, zhpm, file) -> float:
        """Rank 0 prints the gathered records: each rank's lane rows
        (``rank:lane``), its ``TOTAL @ rank#N`` row, then ``<n>proc ...
        TOTAL`` over the slowest rank's time (``cloudsc2jax/timer.py:
        303-352``; timer_mod.F90:157-171)."""
        rec = self._gather_records(zhpm).tolist()
        me = tdist.get_rank()
        if me != 0:
            summ = rec[me][-1]
            return summ[2] / (summ[4] * 1e-3)
        print(
            f"{'rank:lane':>12} {'NGPTOT':>10} {'#GP-cols':>10} {'#calls':>8}"
            f" {'NPROMA':>8} {'time(msec)':>12} {'MFlops/s':>12} {'col/s':>14}",
            file=file,
        )
        tot_cols, tot_mflops, tmax = 0, 0.0, 0.0
        for r, records in enumerate(rec):
            for row in records[:-1]:
                if row[3] == 0 and row[2] == 0:
                    continue  # padding
                t = max(row[4] * 1e-3, 1e-12)
                print(
                    f"{f'{r}:{int(row[0])}':>12} {ngptot:>10} {int(row[2]):>10}"
                    f" {int(row[3]):>8} {nproma:>8} {row[4]:>12.1f}"
                    f" {row[5]:>12.0f} {row[2]/t:>14.0f}{_tag(row[7], row[6])}",
                    file=file,
                )
            summ = records[-1]
            t = max(summ[4] * 1e-3, 1e-12)
            print(
                f"{f'rank{r}':>12} {ngptot:>10} {int(summ[2]):>10}"
                f" {int(summ[3]):>8} {nproma:>8} {summ[4]:>12.1f}"
                f" {summ[5]:>12.0f} {summ[2]/t:>14.0f}  TOTAL @ rank#{r}",
                file=file,
            )
            tot_cols += int(summ[2])
            tot_mflops += summ[5]
            tmax = max(tmax, t)
        print(
            f"{f'{len(rec)}proc':>12} {ngptot:>10} {tot_cols:>10} {ngpblks:>8}"
            f" {nproma:>8} {1e3*tmax:>12.1f} {tot_mflops:>12.0f}"
            f" {tot_cols/tmax:>14.0f}  TOTAL",
            file=file,
        )
        return tot_cols / tmax


def _tag(measured, mirrored) -> str:
    return "  (measured)" if measured else "  (mirror)" if mirrored else ""
