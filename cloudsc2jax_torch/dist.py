"""Column decomposition over lanes and processes.

Port of :mod:`cloudsc2jax.dist` (reference ``cloudsc_mpi_mod.F90``: init,
the reductions of the validation and the timer's gather; the domain
decomposition over grid points of ``dwarf_cloudsc.F90:66-69``):

* **processes** — ``torch.distributed`` over the ``gloo`` backend,
  started from the environment (:func:`initialize`: ``CLOUDSC2_NUM_PROCESSES``,
  ``CLOUDSC2_PROCESS_ID``, ``CLOUDSC2_COORDINATOR``, as the JAX CLI reads
  them).  Each process materialises only its own columns
  (:func:`local_column_slice`, the per-rank hyperslab of
  ``expand_mod.F90:30-46``).
* **lanes** — the devices of one process.  A :class:`ColumnMesh` holds them;
  its global lane count is the world size times the local lanes (the
  counterpart of ``column_mesh`` / ``Mesh``).  CUDA lanes are distinct
  cards; CPU lanes may repeat, as ``jax_num_cpu_devices`` gives the JAX
  package a mesh of virtual CPU devices.  Every lane keeps the levels-major
  kernel layout ``(nlev[+1], ncol)``: the kernels run per lane on its own
  columns, asynchronously on distinct cards, with no communication (the
  physics never couples columns, SURVEY §3.4).
* **collectives** — only small host tensors cross the group: the
  validation statistics, the chunk checksum and the timer's table.  The
  device-side reductions run per lane first (:meth:`ColumnMesh.reduce`).
  ``gloo`` carries them whatever the lanes are: two processes that share
  one card, as a one-card machine runs them, are refused by NCCL.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

__all__ = [
    "ColumnMesh",
    "column_mesh",
    "dryrun",
    "finalize",
    "initialize",
    "lane_slices",
    "local_column_slice",
    "pad_columns",
    "rank",
    "rank_columns",
    "shard_inputs",
    "world_size",
]

# the coordinator's address when CLOUDSC2_COORDINATOR is not set
# (cloudsc2jax/cli.py:102-104)
DEFAULT_COORDINATOR = "localhost:12321"
# how long the rendezvous and every collective wait for the other ranks
# before they fail
TIMEOUT = datetime.timedelta(seconds=300)

_OPS = {"sum": tdist.ReduceOp.SUM, "min": tdist.ReduceOp.MIN,
        "max": tdist.ReduceOp.MAX}


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the process group (CLOUDSC_MPI_INIT, cloudsc_mpi_mod.F90:58-88).

    Each argument left ``None`` is read from the environment:
    ``CLOUDSC2_NUM_PROCESSES`` (default 1), ``CLOUDSC2_PROCESS_ID`` and
    ``CLOUDSC2_COORDINATOR`` (``host:port`` of rank 0, default
    ``localhost:12321``).  One process: nothing to do.  More: a ``gloo``
    group over ``tcp://<coordinator>`` with that rank and world size; a
    rank that cannot reach the others fails after :data:`TIMEOUT`, never
    falls back to running alone.  Returns whether this call created the
    group (its caller then owns :func:`finalize`); a group that exists
    already must have the same size."""
    if num_processes is None:
        num_processes = int(os.environ.get("CLOUDSC2_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if tdist.is_initialized():
        if tdist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of {tdist.get_world_size()} exists; asked "
                f"for {num_processes} processes")
        return False
    if process_id is None:
        if "CLOUDSC2_PROCESS_ID" not in os.environ:
            raise RuntimeError(f"CLOUDSC2_NUM_PROCESSES={num_processes} needs "
                               "CLOUDSC2_PROCESS_ID, this process's rank")
        process_id = int(os.environ["CLOUDSC2_PROCESS_ID"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} outside 0..{num_processes - 1}")
    coordinator = coordinator or os.environ.get("CLOUDSC2_COORDINATOR",
                                                DEFAULT_COORDINATOR)
    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id,
                             timeout=TIMEOUT)
    return True


def finalize() -> None:
    """Leave the process group, if there is one (CLOUDSC_MPI_END)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


class ColumnMesh:
    """This process's lanes in the process group (one process without a
    group).  Lanes are ``torch.device``s of one type: distinct CUDA cards,
    or CPU lanes, which may repeat.  Every process must hold the same number
    of lanes; constructing a mesh in a group checks that, collectively, so
    every rank constructs its mesh at the same point."""

    def __init__(self, lanes: Sequence):
        lanes = [torch.device(d) for d in lanes]
        if not lanes:
            raise ValueError("a mesh needs at least one lane")
        kinds = {d.type for d in lanes}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"lanes must all be CPU or all CUDA devices: {lanes}")
        if lanes[0].type == "cuda":
            lanes = [d if d.index is not None
                     else torch.device("cuda", torch.cuda.current_device())
                     for d in lanes]
            if len(set(lanes)) != len(lanes):
                raise ValueError(f"CUDA lanes must be distinct cards, got "
                                 f"{[str(d) for d in lanes]}: a repeated card "
                                 "would time-slice, not add a lane")
        self.lanes: List[torch.device] = lanes
        self.world = world_size()
        self.rank = rank()
        if self.world > 1:
            n = torch.tensor([len(lanes), -len(lanes)], dtype=torch.int64)
            tdist.all_reduce(n, op=tdist.ReduceOp.MAX)
            if n[0] != -n[1]:
                raise ValueError(f"ranks hold {-int(n[1])} to {int(n[0])} lanes; "
                                 "every rank needs the same number")

    @property
    def device_type(self) -> str:
        return self.lanes[0].type

    @property
    def nlanes(self) -> int:
        """Lanes of this process."""
        return len(self.lanes)

    @property
    def size(self) -> int:
        """Lanes of the whole group."""
        return self.world * self.nlanes

    def global_lane(self, lane: int) -> int:
        return self.rank * self.nlanes + lane

    def context(self, lane: int):
        """The lane's card as the current device (launches, allocations and
        the current stream follow it); nothing for a CPU lane."""
        if self.device_type == "cuda":
            return torch.cuda.device(self.lanes[lane])
        return contextlib.nullcontext()

    def map(self, fn: Callable, per_lane: Sequence) -> list:
        """``[fn(x) for x in per_lane]``, each call with its lane's card
        current.  The calls only enqueue work, so lanes on distinct cards
        run at once."""
        if len(per_lane) != self.nlanes:
            raise ValueError(f"{len(per_lane)} inputs for {self.nlanes} lanes")
        out = []
        for lane, x in enumerate(per_lane):
            with self.context(lane):
                out.append(fn(x))
        return out

    def reduce(self, per_lane: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
        """Reduce same-shaped tensors, one per lane (on the lane's device),
        over the lanes and then over the ranks: each lane's tensor comes to
        the host, the lanes are reduced there, and one host tensor crosses
        the group.  ``op`` is ``"sum"`` (in float64), ``"min"`` or
        ``"max"``.  Every rank gets the result, a CPU tensor."""
        stacked = torch.stack([x.detach().to("cpu", torch.float64) for x in per_lane])
        local = {"sum": lambda t: t.sum(0), "min": lambda t: t.amin(0),
                 "max": lambda t: t.amax(0)}[op](stacked)
        if self.world > 1:
            local = local.contiguous()
            tdist.all_reduce(local, op=_OPS[op])
        return local

    def __repr__(self) -> str:
        return (f"ColumnMesh(rank {self.rank} of {self.world}, lanes "
                f"{[str(d) for d in self.lanes]})")


def column_mesh(device="cuda", n_lanes: Optional[int] = None) -> ColumnMesh:
    """This process's mesh: ``n_lanes`` lanes of ``device``'s type.

    CPU: ``n_lanes`` CPU lanes (default 1).  CUDA: ``n_lanes`` distinct
    cards (default: the cards divided among the ranks, at least one),
    starting at card ``(rank·n_lanes) % count`` and wrapping, so that the
    ranks of one host take cards in turn and ranks beyond the cards share
    them (two ranks on a one-card machine both run on card 0).  More lanes
    than cards is refused."""
    device = torch.device(device)
    if device.type == "cpu":
        return ColumnMesh([device] * (n_lanes or 1))
    if device.type != "cuda":
        raise ValueError(f"no mesh of {device.type} lanes")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device")
    count = torch.cuda.device_count()
    n = n_lanes or max(1, count // world_size())
    if n > count:
        raise ValueError(f"{n} lanes need {n} distinct cards; this machine "
                         f"has {count}")
    first = rank() * n
    return ColumnMesh([torch.device("cuda", (first + i) % count) for i in range(n)])


def rank_columns(ngptot: int, nranks: int, rank: int) -> slice:
    """The reference's per-rank split: NGPTOT = (NGPTOTG-1)/NUMPROC+1 per
    rank, the remainder on the last (dwarf_cloudsc.F90:66-69)."""
    per = (ngptot - 1) // nranks + 1
    start = min(rank * per, ngptot)
    return slice(start, min(start + per, ngptot))


def local_column_slice(ngptot: int, mesh: Optional[ColumnMesh] = None) -> slice:
    """The global columns this process materialises (per-rank hyperslab)."""
    if mesh is None:
        return slice(0, ngptot)
    return rank_columns(ngptot, mesh.world, mesh.rank)


def lane_slices(ngptot: int, mesh: ColumnMesh) -> List[slice]:
    """The global columns of each local lane: the process's slice split by
    the same rule over its lanes.  With ``ngptot`` a multiple of
    ``mesh.size`` (:func:`pad_columns`) every lane gets as many columns."""
    mine = local_column_slice(ngptot, mesh)
    n = mine.stop - mine.start
    return [slice(mine.start + s.start, mine.start + s.stop)
            for s in (rank_columns(n, mesh.nlanes, lane)
                      for lane in range(mesh.nlanes))]


def pad_columns(ngptot: int, mesh: ColumnMesh) -> int:
    """Round the column count up to a multiple of the mesh's lanes, so that
    every lane gets an equal share (the inputs are expanded cyclically, so
    the padding columns are more replicas; results stay
    decomposition-invariant)."""
    n = mesh.size
    return math.ceil(ngptot / n) * n


def shard_inputs(inputs, mesh: ColumnMesh) -> list:
    """One copy of the levels-major ``inputs`` per local lane: this
    process's columns (all of them for one process, as
    :func:`local_column_slice` gives a rank), split over the lanes as
    :func:`lane_slices` splits them, each part contiguous on its lane's
    device.  ``None`` fields stay ``None``."""
    ncol = inputs.pt.shape[1]
    out = []
    for lane, dev in enumerate(mesh.lanes):
        s = rank_columns(ncol, mesh.nlanes, lane)
        out.append(type(inputs)(*(None if x is None
                                  else x[:, s].to(dev).contiguous()
                                  for x in inputs)))
    return out


def dryrun(n_lanes: int, device="cuda", *, ncol: int = 256, nlev: int = 137,
           dtype: torch.dtype = torch.float32) -> dict:
    """The column decomposition end to end at a small size
    (``__graft_entry__.dryrun_multichip``): the NL step on the stream
    contract and the TL+AD unit over ``n_lanes`` lanes of ``device``'s type
    (distinct cards on CUDA), ``ncol`` columns each, every lane expanding
    its own, against one lane over this process's columns.  Raises unless every output
    is finite and the lanes' union agrees with the one lane (relative to
    the field's max: 1e-10 in f64, 1e-5 in f32; the plain versions' CPU
    transcendentals round by vector width, the kernels per column);
    returns the worst error of each."""
    from .drivers import run_nl, run_tlad
    from .state import Cloudsc2State

    mesh = column_mesh(device, n_lanes)
    total = ncol * mesh.size
    mine = local_column_slice(total, mesh)
    state = Cloudsc2State.synthetic(ngptot=100, nlev=nlev)

    def lanes(pqs):
        return [state.device_kernel_inputs(s.stop - s.start, dtype=dtype,
                                           device=dev, pqs=pqs, col_offset=s.start)
                for dev, s in zip(mesh.lanes, lane_slices(total, mesh))]

    def one(pqs):
        return state.device_kernel_inputs(mine.stop - mine.start, dtype=dtype,
                                          device=mesh.lanes[0], pqs=pqs,
                                          col_offset=mine.start)

    tol = 1e-10 if dtype == torch.float64 else 1e-5
    worst = {}
    for name, split, whole in (
            ("nl", run_nl(lanes(False), state.params, mesh=mesh),
             run_nl(one(False), state.params)),
            ("tlad", run_tlad(lanes(True), state.params, mesh=mesh),
             run_tlad(one(True), state.params))):
        err = 0.0
        for parts, ref in zip(zip(*[_leaves(o) for o in split]), _leaves(whole)):
            got = torch.cat([p.to(ref.device) for p in parts], dim=-1)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"dryrun {name}: non-finite outputs")
            scale = ref.abs().max().clamp_min(1e-30)
            err = max(err, float((got - ref).abs().max() / scale))
        if not err <= tol:
            raise AssertionError(f"dryrun {name}: {mesh.nlanes} lanes differ "
                                 f"from one lane by {err:.3e} (tol {tol:g})")
        worst[name] = err
    return worst


def _leaves(tree) -> list:
    """The tensors of a nested tuple, in order; ``None`` skipped."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            out.extend(_leaves(x))
    return out
