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
is not called.  The ``tl_sweep`` and ``ad_sweep`` spans of the
hand-written kernels' launches carry the counters of the kernel instance
launched (:func:`~cloudsc2jax_torch.kernels.tlad_kernel.occupancy`):
``dtype`` (its bits), ``registers`` and ``local_bytes`` per thread,
``shared_bytes`` (dynamic, per block) and ``blocks_per_sm``.  The
``contract`` span of the output contract's assembly
(:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.assemble_contract`)
carries ``in_place`` (1 where the sweep wrote its flux rows into the
contract's flux fields, 0 for a copy of streams it did not allocate) and
``bytes`` (what the assembly read and wrote), on the card and the CPU.

The spans of a call (``drivers.run_nl``, ``run_tlad`` and the layers they
reach): ``run_nl``, ``run_tlad``; ``prelude`` (``kernel_prelude``);
``nl_sweep``, ``tl_sweep``, ``fwd_sweep``, ``ad_sweep`` (the hand-written
kernels' launches, or their plain versions); ``increments`` (the 16
``DSCALE*x`` of the standard contract's unit), ``levels_major``
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
from typing import Dict, List, Optional

import torch

__all__ = ["CAP", "PREFIX", "Recorder", "clear", "count", "records", "span",
           "spanned", "summary"]

PREFIX = "cloudsc2."
# records kept; the oldest go first past it
CAP = 100_000

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("id", "name", "call", "parent", "host_ns", "card", "clock",
                 "device_ms", "counters")

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


class Recorder:
    """The records of the spans, bounded to ``cap``, and the stack of the
    spans open in each thread."""

    def __init__(self, cap: int = CAP):
        self._records = collections.deque(maxlen=cap)
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._local = threading.local()

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
        stack.append(rec)
        with torch.profiler.record_function(rec.name):
            host0 = time.perf_counter_ns()
            start = self._event(stream) if cuda else host0
            try:
                yield
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

    def _resolve(self, rec: _Record) -> None:
        start, end = rec.clock
        if rec.card is None:
            rec.device_ms = (end - start) * 1e-6
        else:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        rec.clock = None

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
        records that carry it (empty where none does)."""
        recs = self.records(calls)
        covered = collections.Counter()
        for r in recs:
            if r.parent is not None:
                covered[r.parent] += r.device_ms
        out: Dict[str, dict] = {}
        seen: Dict[str, Dict[str, list]] = collections.defaultdict(dict)
        for r in recs:
            s = out.setdefault(r.name, {"count": 0, "device_ms": 0.0,
                                        "self_ms": 0.0, "host_ms": 0.0})
            s["count"] += 1
            s["device_ms"] += r.device_ms
            s["self_ms"] += r.device_ms - covered[r.id]
            s["host_ms"] += r.host_ns * 1e-6
            for k, v in (r.counters or {}).items():
                seen[r.name].setdefault(k, []).append(v)
        for name, s in out.items():
            s["counters"] = {k: sum(v) / len(v) for k, v in seen[name].items()}
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
