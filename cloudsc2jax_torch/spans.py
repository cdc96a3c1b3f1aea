"""The port's spans: where a call's time goes, layer by layer, while
``torch.profiler`` records.

``with span("prelude", like):`` (or ``@spanned("prelude")`` on a function
whose first argument holds tensors) marks one layer of a call.  With the
profiler off, the default and every timed run, a span is one check of
``torch.autograd._profiler_enabled()`` and nothing else.  With it on (the
benchmark's traced part, the CLI's ``--profile``) each span

* opens a ``torch.profiler.record_function("cloudsc2.<name>")`` range, so it
  sits in the profiler's own trace beside the device's operations;
* reads the host clock at its start and end;
* times the device with a pair of CUDA events on the current stream of
  ``like``'s card (the host clock where ``like`` is on the CPU, where a
  plain version has finished when it returns);
* records its parent span and its call: the sequence number of the
  outermost span open when it began (``run_nl`` or ``run_tlad``), shared by
  every span of one call.

Records stay in memory, the newest :data:`CAP` of them.  :func:`summary`
resolves them after the caller's synchronise: per range name, the count,
the device and host milliseconds, the self device milliseconds (the
duration less what the span's children cover) and the counters.  A span
does not nest in a span of its own name: the inner one is part of the
outer.

``count(get)`` inside a span gives the innermost open span the counters
``get()`` returns, a small dict of numbers; with the profiler off ``get``
is not called.  The ``nl_sweep``, ``tl_sweep`` and ``ad_sweep`` spans of
the hand-written kernels' launches carry the counters of the kernel
instance launched (:func:`~cloudsc2jax_torch.kernels.build.occupancy`):
``dtype`` (its bits), ``registers`` and ``local_bytes`` per thread,
``shared_bytes`` (dynamic, per block) and ``blocks_per_sm``; the standard
contract's TL (``launch_cloudsc2_tl_std``) adds ``checkpoints`` 1, the
carries it wrote for the reverse sweep.  The
``contract`` span of the output contract's assembly
(:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.assemble_contract`)
carries ``in_place`` (1 where the sweep wrote its flux rows into the
contract's flux fields, 0 for a copy of streams it did not allocate) and
``bytes`` (what the assembly read and wrote), on the card and the CPU.

In one recorded call of every :data:`STAMP_EVERY` (the first, then every
eighth), the NL, TL and AD sweeps' launches run their kernels' traced
twins (:func:`stamped`), which stamp each warp of the grid: lane 0 writes
one 16-byte record (:data:`RECORD`) when its warp starts and after its last
level (``csrc/cloudsc2_stamps.cuh``); the other calls launch the shipped
kernels, which the sweeps' times and counters describe.  The clock is
``%globaltimer``, the card's global nanosecond timer, which every SM reads
alike; on an NVIDIA H100 80GB HBM3 its smallest nonzero step between two
warps' starts read 32 ns.  The records go to one ring a card of
:data:`STAMP_RING` records (64 MiB), allocated at the outermost span of the
first call recorded on that card, before its first launch, and reused;
:meth:`Recorder.stamps` hands a launch its slice and keeps the slice's place
on the sweep's record.  :func:`records` reads a record's slice where it resolves
its events, after the caller's synchronise, and gives the span the
counters of the launch (:func:`stamp_counters`): ``fill_pct``, the warps'
summed time over what the card's SMs, each holding ``twin_blocks_per_sm``
blocks (the twin's own occupancy, which the launch counts beside the
shipped instance's, each of its counters as ``twin_<name>``), could have
held from the first warp's start to the last warp's end; ``kernel_ms``,
that interval; ``tail_ms``, from the first SM to finish its last warp to
the kernel's end; ``sms``, the SMs that ran a warp.  A record whose slice
later launches have overwritten gets none of them.  :func:`summary` takes
a stamped sweep's device times and shared counters from the records of
the same name that launched the shipped kernel, where there are any.

The spans of a call (``drivers.run_nl``, ``run_tlad`` and the layers they
reach): ``run_nl``, ``run_tlad``; ``prelude`` (``kernel_prelude``);
``nl_sweep``, ``tl_sweep``, ``fwd_sweep``, ``ad_sweep`` (the hand-written
kernels' launches, or their plain versions; ``fwd_sweep`` is the
forward-checkpoint sweep of the standard contract's adjoint drop-in, which
the TL+AD unit does not run); ``levels_major``
(``to_levels_major``) and ``contract`` (``assemble_contract``, which
``unblock_outputs`` and the standard contract's TL and AD halves run,
``seed_streams``, ``assemble_shifted_adjoints``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["CAP", "PREFIX", "RECORD", "Recorder", "STAMPED", "STAMP_EVERY", "STAMP_RING",
           "SWEEP_THREADS", "clear", "count", "records", "span", "spanned",
           "stamp_counters", "stamped", "summary"]

PREFIX = "cloudsc2."
# records kept; the oldest go first past it
CAP = 100_000
# warps' records a card's ring holds: 2 sweeps a call of 10,240 warps
# (327,680 columns, 128 a block) for 204 calls, 64 MiB
STAMP_RING = 1 << 22
# the recorded calls whose sweeps stamp their warps: one in this many
STAMP_EVERY = 8
# the device types whose launches stamp
STAMPED = ("cuda",)
# threads a block of the NL, TL and AD sweeps, one a column (kThreads of
# csrc/cloudsc2_{nl,tl,ad}_sweep.cuh)
SWEEP_THREADS = 128
# a warp's record (cloudsc2_stamps::Record): two int64 words, the start in
# ns and the warp's duration in ns with its SM above it, the high 32 bits
RECORD = 2

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("id", "name", "call", "parent", "host_ns", "card", "clock",
                 "device_ms", "counters", "stamps", "stamped")

    def __init__(self, id_, name, call, parent):
        self.id = id_
        self.name = name
        self.call = call
        self.parent = parent
        self.host_ns = None
        self.card = None  # the CUDA device's index; None on the CPU
        self.clock = None  # (start, end): CUDA events, or host ns on the CPU
        self.device_ms = None
        self.counters = None  # {name: number}, from count()
        # (device, start, warps, warps a block): the launch's slice of the
        # ring, `start` counted from the ring's first use
        self.stamps = None
        self.stamped = False  # a stamped twin ran in place of the kernel


def stamp_counters(records: torch.Tensor, sms: int,
                   resident_warps: Optional[int]) -> Dict[str, float]:
    """The counters of one stamped launch from its warps' ``(n, RECORD)``
    records on the host: ``kernel_ms`` (the last warp's end less the first
    warp's start), ``tail_ms`` (the last end less the earliest of the SMs'
    last ends), ``sms`` (the SMs seen) and, where ``resident_warps`` (the
    warps an SM holds at once) is known and the kernel took time,
    ``fill_pct``: 100 times the warps' summed durations over ``sms`` SMs
    holding ``resident_warps`` each for ``kernel_ms``."""
    start = records[:, 0]
    duration = records[:, 1] & 0xFFFFFFFF
    end = start + duration
    first, last = int(start.min()), int(end.max())
    sm, which = torch.unique(records[:, 1] >> 32, return_inverse=True)
    sm_last = torch.full((len(sm),), first, dtype=end.dtype).scatter_reduce(
        0, which, end, "amax")
    out = {"kernel_ms": (last - first) * 1e-6,
           "tail_ms": (last - int(sm_last.min())) * 1e-6, "sms": len(sm)}
    if resident_warps and last > first:
        out["fill_pct"] = 100.0 * int(duration.sum()) / (sms * resident_warps
                                                         * (last - first))
    return out


def _means(recs) -> Dict[str, float]:
    """Each counter's mean over the records of ``recs`` that carry it."""
    seen: Dict[str, list] = {}
    for r in recs:
        for k, v in (r.counters or {}).items():
            seen.setdefault(k, []).append(v)
    return {k: sum(v) / len(v) for k, v in seen.items()}


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class Recorder:
    """The records of the spans, bounded to ``cap``, the stack of the spans
    open in each thread, and per card the ring of :data:`STAMP_RING` warps'
    records that the launches on devices of the types :data:`STAMPED`
    fill."""

    def __init__(self, cap: int = CAP):
        self._records = collections.deque(maxlen=cap)
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._local = threading.local()
        self._rings: Dict[torch.device, list] = {}  # device: [records, head]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @staticmethod
    def _event(stream) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, like: torch.Tensor):
        stack = self._stack()
        if stack and stack[-1].name == PREFIX + name:
            yield
            return
        parent = stack[-1] if stack else None
        rec = _Record(next(self._ids), PREFIX + name,
                      parent.call if parent else next(self._calls),
                      parent.id if parent else None)
        cuda = like.device.type == "cuda"
        if cuda:
            rec.card = like.device.index
            stream = torch.cuda.current_stream(like.device)
        if parent is None and like.device.type in STAMPED:
            self._ring_of(like.device)
        stack.append(rec)
        with torch.profiler.record_function(rec.name):
            host0 = time.perf_counter_ns()
            start = self._event(stream) if cuda else host0
            try:
                yield
            except BaseException:
                rec.stamps = None  # the launch may not have run
                rec.stamped = False
                raise
            finally:
                end = self._event(stream) if cuda else time.perf_counter_ns()
                host1 = time.perf_counter_ns()
                stack.pop()
                rec.host_ns = host1 - host0
                rec.clock = (start, end)
                self._records.append(rec)

    def count(self, get) -> None:
        """Give the innermost open span of this thread the counters
        ``get()`` returns; nothing where no span is open."""
        stack = self._stack()
        if stack:
            rec = stack[-1]
            rec.counters = {**(rec.counters or {}), **get()}

    def _ring_of(self, device: torch.device) -> list:
        ring = self._rings.get(device)
        if ring is None:
            ring = self._rings[device] = [
                torch.empty((STAMP_RING, RECORD), dtype=torch.int64, device=device), 0]
        return ring

    def stamps(self, like: torch.Tensor, warps: int,
               warps_per_block: int) -> Optional[torch.Tensor]:
        """The next ``warps`` records of the ring of ``like``'s card, a
        slice of it that does not wrap, kept on the innermost open span of
        this thread; None where no span is open, the call is not one in
        :data:`STAMP_EVERY`, ``like`` is on a device not stamped or the
        ring is too small for the launch."""
        stack = self._stack()
        if (not stack or stack[0].call % STAMP_EVERY or like.device.type not in STAMPED
                or warps > STAMP_RING):
            return None
        ring = self._ring_of(like.device)
        start = ring[1]
        if start % STAMP_RING + warps > STAMP_RING:
            start += STAMP_RING - start % STAMP_RING
        ring[1] = start + warps
        stack[-1].stamps = (like.device, start, warps, warps_per_block)
        stack[-1].stamped = True
        first = start % STAMP_RING
        return ring[0][first:first + warps]

    def _resolve(self, rec: _Record) -> None:
        start, end = rec.clock
        if rec.card is None:
            rec.device_ms = (end - start) * 1e-6
        else:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        rec.clock = None
        if rec.stamps is not None:
            self._resolve_stamps(rec)

    def _resolve_stamps(self, rec: _Record) -> None:
        """Give ``rec`` the counters of its launch's slice of the ring,
        where no later slice has been handed out over it."""
        device, start, warps, per_block = rec.stamps
        rec.stamps = None
        records, head = self._rings[device]
        if head > start + STAMP_RING:
            return
        first = start % STAMP_RING
        counters = rec.counters or {}
        blocks = counters.get("twin_blocks_per_sm")
        rec.counters = {**counters, **stamp_counters(
            records[first:first + warps].cpu(), _sm_count(device),
            None if blocks is None else blocks * per_block)}

    def records(self, calls: Optional[int] = None) -> List[_Record]:
        """The records, resolved, oldest first; those of the last ``calls``
        calls only where given."""
        recs = list(self._records)
        for rec in recs:
            if rec.device_ms is None:
                self._resolve(rec)
        if calls is not None:
            keep = set(sorted({r.call for r in recs})[-calls:]) if calls > 0 else set()
            recs = [r for r in recs if r.call in keep]
        return recs

    def summary(self, calls: Optional[int] = None) -> Dict[str, dict]:
        """Per range name: ``count``, ``device_ms``, ``self_ms`` and
        ``host_ms``, totals over the records (of the last ``calls`` calls
        where given), and ``counters``: each counter's mean over the
        records that carry it (empty where none does).  Where some records
        of a name launched a stamped twin and others the shipped kernel,
        ``device_ms`` and ``self_ms`` are the others' means times the
        count, and a counter that both carry is the others' mean."""
        recs = self.records(calls)
        covered = collections.Counter()
        groups: Dict[str, list] = {}
        for r in recs:
            if r.parent is not None:
                covered[r.parent] += r.device_ms
            groups.setdefault(r.name, []).append(r)
        out: Dict[str, dict] = {}
        for name, group in groups.items():
            shipped = [r for r in group if not r.stamped] or group
            twins = [r for r in group if r.stamped] if len(shipped) < len(group) else []
            scale = len(group) / len(shipped)
            out[name] = {
                "count": len(group),
                "device_ms": scale * sum(r.device_ms for r in shipped),
                "self_ms": scale * sum(r.device_ms - covered[r.id] for r in shipped),
                "host_ms": sum(r.host_ns for r in group) * 1e-6,
                "counters": {**_means(twins), **_means(shipped)}}
        return out

    def clear(self) -> None:
        self._records.clear()


_recorder = Recorder()


def span(name: str, like: torch.Tensor):
    """A context manager marking one layer of a call; ``like`` is a tensor
    on the device the layer runs on.  Off (one check) unless
    ``torch.profiler`` records."""
    if not _enabled():
        return _OFF
    return _recorder.span(name, like)


def _first_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return next(v for v in x if isinstance(v, torch.Tensor))


def spanned(name: str):
    """``fn`` inside :func:`span` ``(name, like)``, ``like`` the first
    tensor of its first argument (a tensor, or a tuple holding tensors)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _recorder.span(name, _first_tensor(args[0])):
                return fn(*args, **kwargs)
        return inner
    return wrap


def stamped(entry: str, like: torch.Tensor, ncol: int) -> Tuple[str, tuple]:
    """The entry a launch of the NL, TL or AD sweep ``entry`` over ``ncol``
    columns of ``like`` calls and the arguments it adds before the stream:
    ``entry`` and none, after one check, unless ``torch.profiler`` records
    and :meth:`Recorder.stamps` hands the launch a slice of records; then
    ``<entry>_stamped`` (the kernel's twin that stamps each warp,
    ``csrc/cloudsc2_stamps.cuh``) and that slice."""
    if not _enabled():
        return entry, ()
    warps = SWEEP_THREADS // 32
    records = _recorder.stamps(like, -(-ncol // SWEEP_THREADS) * warps, warps)
    return (entry, ()) if records is None else (f"{entry}_stamped", (records,))


def count(get) -> None:
    """Give the innermost open span the counters ``get()`` returns (a dict
    of numbers); ``get`` is not called unless ``torch.profiler`` records."""
    if _enabled():
        _recorder.count(get)


def summary(calls: Optional[int] = None) -> Dict[str, dict]:
    """:meth:`Recorder.summary` of the process's spans."""
    return _recorder.summary(calls)


def records(calls: Optional[int] = None) -> list:
    """:meth:`Recorder.records` of the process's spans."""
    return _recorder.records(calls)


def clear() -> None:
    """Forget the process's spans."""
    _recorder.clear()
