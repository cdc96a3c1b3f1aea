"""Emit the tangent-linear and adjoint level bodies of the CUDA kernels.

Run from the root of a checkout, with no arguments, to rewrite both
generated headers::

    python -m cloudsc2jax_torch.kernels.emit

The TPU kernels (``cloudsc2jax/pallas/tlad_kernel.py``) get their
derivative statements from in-kernel ``jax.jvp``/``jax.vjp`` of the level
body at trace time; the derivatives are never written by hand.  The port
keeps that rule with a trace of its own level body:

1. :func:`trace` runs ``make_fx`` over ``torch.func.jvp`` (TL) or
   ``torch.func.vjp`` (AD) of
   :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.level_physics`, on the
   CPU in float64.  ``functionalize`` removes the
   in-place and view ops of the autograd formulas, and
   ``eliminate_dead_code`` what no output needs.
2. :func:`emit_header` prints one C++ statement per node into
   ``csrc/cloudsc2_tl_level.cuh`` (primal + tangent of one level) or
   ``csrc/cloudsc2_ad_level.cuh`` (primal recompute + transpose of one
   level).  ``levapls2 or ldrain1d`` and ``lregcl`` are decided at compile
   time: each header holds the four bodies ``Level<EVAP, LREGCL>``.  With
   ``lregcl`` off the five damp sites vanish from the trace, so that body
   is the exact derivative the Taylor test needs.

Every node gets one of three kinds:

* **param**: a model parameter or a value computed from parameters and
  Python literals only.  The params are traced as 0-d float64 inputs, so
  these nodes are exactly the constants Python folds in double before they
  meet a tensor.  They become host code in double
  (``Level<E>::constants``, run once per launch); the ones an array
  statement reads arrive in the kernel as ``k[j]``, rounded to the working
  type once.  No parameter value appears in the generated source.
* **value**: anything that reads a field, a carry, a per-level scalar or a
  tangent: one ``const T`` (or ``const bool``) statement in the level body,
  in the working type ``T``.
* a Python literal in an argument is printed with ``repr`` and rounded to
  ``T`` where it meets a value, as PyTorch rounds a Python scalar.

The bookkeeping of the autograd formulas (``alias_copy``,
``expand_copy``, ``_to_copy``, ``clone``) becomes copies, printed as the
name of the value they copy, and its zero tensors become ``T(0.0)``; ``where`` stays a select of two computed values.
Any aten target without a rule raises, so no op can vanish silently.  The
kernels' schedule, memory traffic, checkpoints and scatter are written by
hand in ``csrc/cloudsc2_tl_sweep.cuh`` and ``csrc/cloudsc2_ad_sweep.cuh``.

An IEEE division is a reciprocal's refinement, a range check and a branch
to a slow path, each a cut in the code the compiler can schedule, and
``vjp`` of ``a / b`` prints ``g / b``, ``a / b`` again and ``(a / b) / b``.
So every body first divides once per divisor (:func:`divide_once`): a
divisor of two numerators or more gets one correctly rounded reciprocal,
from which each quotient is formed exactly (:func:`quotient`, printed
``xdivr``), quotients printed twice are merged, and a param or literal
divisor becomes a product with its reciprocal folded in double.  A
reciprocal is live beside its divisor from its first quotient to its
last, so where one would lift a TL body's live peak above
``TL_LIVE_BUDGET``, that divisor keeps its divisions
(:func:`divide_within`).

The order of the statements sets the registers a body needs, so the AD
bodies are rescheduled before they are printed (:func:`reschedule`).
``vjp`` traces all of the primal recompute, then all of the transpose:
printed in that order, ~180 values wait across the turn for the transpose
that reads them (:func:`live_peak` counts them), and the kernel needed 168
registers.  The rescheduled graph runs the transpose in its traced order
with each primal statement sunk to just before its first read, and parks
the values with the longest gaps between reads in shared memory
(:func:`stash`, read back by :func:`unstash`; printed ``xstash`` and
``xunstash``, volatile shared-memory accesses the compiler cannot fold back
into a register) until at most ``LIVE_BUDGET`` values are live in
registers, then unparks those whose unparking frees a shared slot within
the budget (5 f32 blocks of ``Level<false, true>`` fit an SM).  No
statement is computed
twice, and the derivative is still the traced one: the rescheduled graph
is a graph of the same aten ops, identities and exact quotients, held to
the traced function by the tests.  (Recomputing the
long-lived values near their reads instead bought the same registers for
~1.75x the arithmetic and ran slower on the card: PERF.md.)  The TL
bodies keep the traced order: their peak is ~60 values.
"""

from __future__ import annotations

import dataclasses
import pathlib
import weakref
from fractions import Fraction
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ..constants import Params
from .cloudsc2_kernel import level_physics

__all__ = ["HEADERS", "LIVE_BUDGET", "REGENERATE", "TL_LIVE_BUDGET", "Trace",
           "VARIANTS", "divide_once", "divide_within", "emit_header", "live_peak", "main",
           "param_value", "quotient", "render_header", "reschedule",
           "shared_slots", "stash", "trace", "trace_params", "unstash"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
HEADERS = {"tl": CSRC / "cloudsc2_tl_level.cuh", "ad": CSRC / "cloudsc2_ad_level.cuh"}
REGENERATE = "python -m cloudsc2jax_torch.kernels.emit"

_GROUPS = ("yomcst", "yoethf", "yrecldp", "yrephli")
_NF, _NCOL, _NCARRY, _NOUT = 17, 2, 3, 8
_TRACE_WIDTH = 8  # columns of the traced tensors; any width gives one graph


def trace_params() -> Params:
    """The parameter set the traces run with: IFS defaults, LEVAPLS2 off.
    Only its structure matters, since every float field is a traced input."""
    return Params.ifs_defaults(ceta=(0.5,))


def _param_paths(params: Params) -> List[str]:
    """Every float field of the groups the level body reads, plus ptsphy."""
    paths = [f"{g}.{f.name}" for g in _GROUPS
             for f in dataclasses.fields(getattr(params, g))
             if type(getattr(getattr(params, g), f.name)) is float]
    return paths + ["ptsphy"]


def param_value(params: Params, path: str) -> float:
    """The value of ``params`` at ``path`` ("ptsphy", "yomcst.rg", ...)."""
    obj = params
    for part in path.split("."):
        obj = getattr(obj, part)
    return float(obj)


def _with_params(params: Params, paths: List[str], values) -> Params:
    """``params`` with the fields named by ``paths`` replaced by ``values``."""
    new = dict(zip(paths, values))
    groups = {
        g: dataclasses.replace(getattr(params, g), **{
            p.split(".")[1]: v for p, v in new.items() if p.startswith(g + ".")})
        for g in _GROUPS
    }
    return dataclasses.replace(params, ptsphy=new["ptsphy"], **groups)


class Trace(NamedTuple):
    """A traced level: the graph, the C name of each of its inputs (in the
    graph's placeholder order) and of each output."""

    graph: torch.fx.GraphModule
    inputs: List[str]
    outputs: List[str]
    params: List[str]  # path of each param input, in placeholder order
    fn: Callable  # the traced function, which the graph computes


def _names(prefix: str, n: int) -> List[str]:
    return [f"{prefix}[{i}]" for i in range(n)]


VARIANTS = tuple((evap, lregcl) for evap in (False, True)
                 for lregcl in (False, True))


def trace(kind: str, evap: bool, lregcl: bool = True) -> Trace:
    """Trace one level's jvp (``kind="tl"``) or vjp (``"ad"``) of
    ``level_physics``, with ``ldrain1d=evap`` and LEVAPLS2 off.

    TL inputs: params, ceta_k, zscalm_k, not_last, the 17 fields, the 2
    columns, the 3 carries, the 17 field tangents, the paph_sfc tangent and
    the 3 carry tangents (the tropopause eta has a zero tangent).  Outputs:
    the 8 level outputs, the 3 new carries, then their tangents.

    AD inputs: params, ceta_k, zscalm_k, not_last, fields, columns, the 3
    carries into the level, the 8 output cotangents and the 3 new-carry
    cotangents.  Outputs: the 17 field cotangents, the paph_sfc cotangent
    and the 3 carry-in cotangents (the tropopause eta's is dropped: it is
    piecewise constant in the inputs).
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    base = trace_params()
    paths = _param_paths(base)
    gen = torch.Generator().manual_seed(0)

    def col(n):
        return tuple(torch.rand(_TRACE_WIDTH, generator=gen, dtype=torch.float64)
                     + 0.5 for _ in range(n))

    def level(pvals, ceta_k, zscalm_k, not_last):
        prm = _with_params(base, paths, pvals)
        return lambda fl, co, ca: level_physics(
            prm, evap, (ceta_k, zscalm_k, not_last), fl, co, ca, lregcl=lregcl)

    scalars = (torch.tensor(0.5, dtype=torch.float64),
               torch.tensor(0.8, dtype=torch.float64), torch.tensor(True))
    pvals = tuple(torch.tensor(param_value(base, p), dtype=torch.float64)
                  for p in paths)
    head = [f"p{i}" for i in range(len(paths))] + ["ceta_k", "zscalm_k", "not_last"]
    if kind == "tl":
        def fn(pvals, ceta_k, zscalm_k, not_last, x, c, r, dx, dsfc, dr):
            g = level(pvals, ceta_k, zscalm_k, not_last)
            dc = (torch.zeros_like(c[0]), dsfc)
            return torch.func.jvp(g, (x, c, r), (dx, dc, dr))

        example = (pvals, *scalars, col(_NF), col(_NCOL), col(_NCARRY),
                   col(_NF), col(1)[0], col(_NCARRY))
        inputs = head + (_names("x", _NF) + _names("c", _NCOL)
                         + _names("r", _NCARRY) + _names("dx", _NF)
                         + ["dpaph_sfc"] + _names("dr", _NCARRY))
        outputs = (_names("y", _NOUT) + _names("ry", _NCARRY)
                   + _names("dy", _NOUT) + _names("dry", _NCARRY))
    elif kind == "ad":
        def fn(pvals, ceta_k, zscalm_k, not_last, x, c, r, s, sr):
            g = level(pvals, ceta_k, zscalm_k, not_last)
            _, vjp_fn = torch.func.vjp(g, x, c, r)
            gx, gc, gr = vjp_fn((s, sr))
            return gx, gc[1], gr

        example = (pvals, *scalars, col(_NF), col(_NCOL), col(_NCARRY),
                   col(_NOUT), col(_NCARRY))
        inputs = head + (_names("x", _NF) + _names("c", _NCOL)
                         + _names("r", _NCARRY) + _names("s", _NOUT)
                         + _names("sr", _NCARRY))
        outputs = _names("gx", _NF) + ["gpaph_sfc"] + _names("gr", _NCARRY)
    else:
        raise ValueError(f"kind must be 'tl' or 'ad', not {kind!r}")

    gm = make_fx(fn)(*example)
    gm = make_fx(torch.func.functionalize(gm, remove="mutations_and_views"))(*example)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return Trace(gm, inputs, outputs, paths, fn)


# ---------------------------------------------------------------- scheduling
def stash(x):
    """The identity, as a graph target: ``x`` stored to a shared-memory
    slot of the thread (printed ``xstash``)."""
    return x


def unstash(x):
    """The identity, as a graph target: the value of a :func:`stash` read
    back into a register (printed ``xunstash``)."""
    return x


class _Kinds(NamedTuple):
    params: set  # placeholders and nodes computed from params only: host code
    constants: set  # literals, and values of literals and params only
    root: Dict[torch.fx.Node, torch.fx.Node]  # copy -> the value it copies
    inputs: List[torch.fx.Node]  # the body's arguments (x, c, r, s, ...)
    values: List[torch.fx.Node]  # the statements that compute a value


def _name(node) -> str:
    for target in (stash, unstash, quotient):
        if node.target is target:
            return target.__name__
    return _op_name(node)[0]


def _kinds(tr: Trace) -> _Kinds:
    nodes = tr.graph.graph.nodes
    places = [n for n in nodes if n.op == "placeholder"]
    npar = len(tr.params)
    params, constants, root, values = set(places[:npar]), set(), {}, []
    for n in nodes:
        if n.op != "call_function":
            continue
        name = _name(n)
        deps = [root.get(d, d) for d in n.all_input_nodes]
        if name in _COPIES:
            src = deps[0]
            root[n] = src
            for group in (params, constants):
                if src in group:
                    group.add(n)
        elif name in _CONSTANTS:
            constants.add(n)
        elif deps and all(d in params for d in deps):
            params.add(n)
        elif all(d in params or d in constants for d in deps):
            constants.add(n)
        else:
            values.append(n)
    return _Kinds(params, constants, root, places[npar:], values)


def _reads(node, kinds: _Kinds):
    """The values and inputs ``node`` reads (a literal's shape argument is
    not read)."""
    if _name(node) in _CONSTANTS:
        return []
    return [kinds.root.get(d, d) for d in node.all_input_nodes]


def _lifetimes(tr: Trace, k: _Kinds):
    """Each value's and input's (first, last) statement index in printed
    order: inputs from -1, a value from its statement, to its last read (an
    output's to the end of the body)."""
    pos = {n: i for i, n in enumerate(k.values)}
    last = {v: -1 for v in k.inputs}
    last.update(pos)
    for n in k.values:
        for d in _reads(n, k):
            if d in last:
                last[d] = max(last[d], pos[n])
    for d in tr.graph.graph.output_node().all_input_nodes:
        d = k.root.get(d, d)
        if d in last:
            last[d] = len(k.values)
    return {v: (pos.get(v, -1), max(stop, pos.get(v, -1))) for v, stop in last.items()}


def _live(spans, n: int) -> List[int]:
    """The number of ``spans`` (first, last statement index) that hold
    statement ``i``, at position ``i + 1`` (from the inputs' ``-1``)."""
    delta = [0] * (n + 3)
    for start, stop in spans:
        delta[start + 1] += 1
        delta[stop + 2] -= 1
    live, counts = 0, []
    for step in delta:
        live += step
        counts.append(live)
    return counts


def _peak(spans, n: int) -> int:
    return max([0, *_live(spans, n)])


def live_peak(tr: Trace) -> int:
    """The largest number of values held in registers at any statement of
    ``tr``'s body in its printed order: T and bool values from their
    statement to their last read (an output's to the end of the body),
    inputs from the start to their last read.  Params (host code), literals
    and values parked in shared memory by :func:`stash` do not count; a
    value read back by :func:`unstash` counts from the read."""
    k = _kinds(tr)
    spans = _lifetimes(tr, k)
    return _peak([s for v, s in spans.items() if v.target is not stash],
                 len(k.values))


def shared_slots(tr: Trace) -> int:
    """The most values parked in shared memory at once (from each
    :func:`stash` to its last :func:`unstash`): the slots per thread the
    body needs."""
    k = _kinds(tr)
    spans = _lifetimes(tr, k)
    return _peak([s for v, s in spans.items() if v.target is stash], len(k.values))


def _split(tr: Trace, k: _Kinds):
    """The statements of an AD trace's body in two lists, each in printed
    order: the primal recompute, and the transpose (every statement that
    reads a seed, ``s`` or ``sr``, or a statement that does)."""
    names = dict(zip((n for n in tr.graph.graph.nodes if n.op == "placeholder"),
                     tr.inputs))
    seeds = {n for n in k.inputs if names[n].startswith(("s[", "sr["))}
    back: set = set()
    for n in k.values:
        if any(d in seeds or d in back for d in _reads(n, k)):
            back.add(n)
    return ([n for n in k.values if n not in back],
            [n for n in k.values if n in back])


# the most values an AD body may hold in registers: at 96 the f32 kernel
# fits the 102 registers of 5 blocks of 128 threads per SM without spilling
# (95 registers; PERF.md).  The evaporating bodies park more values for it
# (~130 slots), so their shared memory bounds them to 3 blocks per SM.
LIVE_BUDGET = 96
# reads of a parked value closer together than this many statements share
# one read back
_GROUP = 8
_SCHEDULED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# the meta key that marks a reciprocal :func:`divide_once` computes in the
# body; its value is the divisor, a node of the graph divided once
_RECIPROCAL = "divide_once"
# the most values a TL body may hold in registers: the 64 registers of the
# f32 kernel's 8 blocks of 128 threads an SM (csrc/cloudsc2_tl_sweep.cuh)
TL_LIVE_BUDGET = 64


def reschedule(tr: Trace) -> Trace:
    """``tr``, an AD trace, in the order the kernel runs it: one division
    per divisor (:func:`divide_once`), the primal statements sunk to the
    transpose's first read (:func:`_sink`), then the longest-lived values
    parked in shared memory until the registers' live peak is within
    ``LIVE_BUDGET`` (:func:`_park`), less those whose unparking frees a
    shared slot within the budget."""
    if tr.graph in _SCHEDULED:
        return _SCHEDULED[tr.graph]
    sunk = _sink(divide_once(tr))
    k = _kinds(sunk)
    spans = _lifetimes(sunk, k)
    uses = _uses(sunk, k)

    def gap(v):
        marks = [spans[v][0], *sorted(set(uses[v]))]
        return max((b - a for a, b in zip(marks, marks[1:])), default=0)

    order = sorted((v for v in spans if v.meta["val"].dtype != torch.bool
                    and gap(v) > _GROUP),
                   key=lambda v: (-gap(v), spans[v][0]))
    for n in range(0, len(order) + 5, 5):
        if _parked_counts(sunk, k, set(order[:n]), uses)[0] <= LIVE_BUDGET:
            break
    parked = set(order[:n])
    slots = _parked_counts(sunk, k, parked, uses)[1]
    for v in reversed(order[:n]):  # shortest gap first: unpark where it frees a slot
        peak, fewer = _parked_counts(sunk, k, parked - {v}, uses)
        if peak <= LIVE_BUDGET and fewer < slots:
            parked.discard(v)
            slots = fewer
    _SCHEDULED[tr.graph] = _park(sunk, k, parked, uses)
    return _SCHEDULED[tr.graph]


def _uses(tr: Trace, k: _Kinds) -> Dict[torch.fx.Node, List[int]]:
    """Per input and value, the statement index of each statement that
    reads it (``len(k.values)`` for an output)."""
    uses: Dict[torch.fx.Node, List[int]] = {v: [] for v in [*k.inputs, *k.values]}
    for i, n in enumerate(k.values):
        for d in set(_reads(n, k)):
            if d in uses:
                uses[d].append(i)
    for d in tr.graph.graph.output_node().all_input_nodes:
        d = k.root.get(d, d)
        if d in uses:
            uses[d].append(len(k.values))
    return uses


def _quotients(tr: Trace, k: _Kinds):
    """The body's divisions (``div`` and ``reciprocal`` statements, and the
    divisions of a literal's value by a literal, which the body prints too:
    a zero tangent over ``0.15``), each with its key ``(numerator,
    divisor)``: values by the node they copy, literals by value (a
    reciprocal's numerator is ``1.0``); and per divisor, the distinct
    numerators it divides."""
    found, numerators = [], {}
    body = set(k.values) | k.constants
    for n in (n for n in tr.graph.graph.nodes if n in body):
        name = _name(n)
        if name == "reciprocal":
            num, div = 1.0, n.args[0]
        elif name == "div" and not n.kwargs:
            num, div = n.args
        else:
            continue
        key = tuple(k.root.get(a, a) for a in (num, div))
        found.append((n, key))
        numerators.setdefault(key[1], {})[key[0]] = None
    return found, numerators


def quotient(a, b, rb):
    """``a / b`` from ``rb``, the correctly rounded ``1 / b``, as a graph
    target (printed ``xdivr``): the product ``q = a * rb``, then one step
    on its residual, ``fma(fma(-b, q, a), rb, q)``, the correction an IEEE
    division ends with (Markstein's), which rounds ``q`` to the correctly
    rounded quotient, bit for bit the division's outside underflow and
    overflow.  Here each ``fma`` is computed exactly and rounded once,
    element by element."""
    a, b, rb = torch.broadcast_tensors(a, b, rb)
    q = a * rb
    r = _fma(-b, q, a)
    return _fma(r, rb, q)


def _fma(x, y, z):
    """``x * y + z`` rounded once, element by element (float64)."""
    if x.dtype != torch.float64:
        raise NotImplementedError(f"emit: exact fma of {x.dtype}")
    out = [float(Fraction(u) * Fraction(v) + Fraction(w))
           for u, v, w in zip(x.flatten().tolist(), y.flatten().tolist(),
                              z.flatten().tolist())]
    return torch.tensor(out, dtype=x.dtype).reshape(x.shape)


def divide_once(tr: Trace, keep=frozenset()) -> Trace:
    """``tr`` with one division per divisor, and quotients printed twice
    merged.  A divisor the body computes (or reads) and divides more than
    one numerator by gets one correctly rounded reciprocal, printed
    ``T(1.0) / b``, from which each of its quotients is formed exactly
    (:func:`quotient`: a multiply and two fused multiply-adds, in place of
    a division).  A divisor of params only gets its reciprocal as host code
    in double, and a literal divisor a literal reciprocal computed in
    double, each rounded to ``T`` once, which its quotients multiply (at
    most 1.5 ulp from the quotient, not 0.5).  A divisor of one numerator,
    or one of ``keep`` (nodes of ``tr``), stays a division."""
    k = _kinds(tr)
    found, numerators = _quotients(tr, k)
    keys = dict(found)
    g = tr.graph.graph
    new = torch.fx.Graph()
    new.set_codegen(g._codegen)
    env: Dict[torch.fx.Node, torch.fx.Node] = {}
    made: Dict[tuple, torch.fx.Node] = {}  # quotient key -> its node
    inverse: Dict[torch.fx.Node, torch.fx.Node] = {}  # divisor -> its reciprocal

    def reciprocal(div):
        if div not in inverse:
            inverse[div] = new.call_function(torch.ops.aten.reciprocal.default,
                                             (env[div],))
            inverse[div].meta = dict(div.meta)
            if div not in k.params:
                inverse[div].meta[_RECIPROCAL] = div
        return inverse[div]

    def call(target, *args):
        return new.call_function(target, args)

    for n in g.nodes:
        if n.op == "placeholder":
            env[n] = new.placeholder(n.name)
            env[n].meta = dict(n.meta)
            continue
        if n not in keys:
            env[n] = new.node_copy(n, lambda a: env[a])
            continue
        num, div = key = keys[n]
        if key not in made:
            if not isinstance(div, torch.fx.Node):
                made[key] = call(torch.ops.aten.mul.Tensor, env[num], 1.0 / div)
            elif div in k.params:
                made[key] = call(torch.ops.aten.mul.Tensor, env[num], reciprocal(div))
            elif len(numerators[div]) > 1 and div not in keep:
                inv = reciprocal(div)
                made[key] = (call(quotient, env[num], env[div], inv)
                             if isinstance(num, torch.fx.Node) else inv)
            else:
                made[key] = new.node_copy(n, lambda a: env[a])
            if made[key] is not inverse.get(div):
                made[key].meta = dict(n.meta)
        env[n] = made[key]
    new.output(torch.fx.node.map_arg(g.output_node().args[0], lambda a: env[a]))
    return Trace(torch.fx.GraphModule(tr.graph, new), tr.inputs, tr.outputs,
                 tr.params, tr.fn)


def divide_within(tr: Trace, budget: int) -> Trace:
    """``tr``, a TL trace, in its traced order with one division per divisor
    (:func:`divide_once`), but where a reciprocal would lift the registers'
    live peak above ``budget`` (or above the traced body's, where that is
    higher): while the peak is over, the divisor whose reciprocal is live
    the longest across the first statement at the peak keeps its
    divisions."""
    keep: set = set()
    limit = max(budget, live_peak(tr))
    while True:
        out = divide_once(tr, keep)
        k = _kinds(out)
        spans = _lifetimes(out, k)
        live = _live(spans.values(), len(k.values))
        peak = max(live)
        at = live.index(peak) - 1  # the first statement at the peak
        over = [v for v, (a, b) in spans.items()
                if _RECIPROCAL in v.meta and a <= at <= b]
        if peak <= limit or not over:
            return out
        keep.add(max(over, key=lambda v: spans[v][1] - spans[v][0]).meta[_RECIPROCAL])


def _sink(tr: Trace) -> Trace:
    """The transpose in its traced order, each primal statement moved down
    to just before the first transpose statement that needs it (with any of
    its primal operands not yet computed): every statement runs once."""
    k = _kinds(tr)
    g = tr.graph.graph
    fwd, order = _split(tr, k)
    primal = set(fwd)
    new = torch.fx.Graph()
    new.set_codegen(g._codegen)
    env: Dict[torch.fx.Node, torch.fx.Node] = {}
    for p in (n for n in g.nodes if n.op == "placeholder"):
        env[p] = new.placeholder(p.name)
        env[p].meta = dict(p.meta)
    shape_of = env[next(p for p, name in zip(
        (n for n in g.nodes if n.op == "placeholder"), tr.inputs) if name == "x[0]")]
    for n in g.nodes:  # host code and literals first: they hold no register
        if n.op == "call_function" and (n in k.params or n in k.constants):
            literal = _name(n) in _CONSTANTS  # reads its argument's shape only
            env[n] = new.node_copy(n, lambda a: env.get(k.root.get(a, a), shape_of)
                                   if literal else env[k.root.get(a, a)])

    def mapped(a):
        return env[k.root.get(a, a)]

    def make(f):
        for d in _reads(f, k):
            if d in primal and d not in env:
                make(d)
        env[f] = new.node_copy(f, mapped)

    for b in order:
        for d in _reads(b, k):
            if d in primal and d not in env:
                make(d)
        env[b] = new.node_copy(b, mapped)
    new.output(torch.fx.node.map_arg(g.output_node().args[0], mapped))
    return Trace(torch.fx.GraphModule(tr.graph, new), tr.inputs, tr.outputs,
                 tr.params, tr.fn)


def _read_groups(parked: set, pos, uses) -> Dict[Tuple[torch.fx.Node, int], object]:
    """Per parked value and read (its statement index), the group of reads
    that one read back serves: "first" for reads within ``_GROUP``
    statements of the value's own statement, which read its register."""
    reader: Dict[Tuple[torch.fx.Node, int], object] = {}
    for v in parked:
        prev, group = pos.get(v, -1), "first"
        for u in sorted(set(uses[v])):
            if u - prev > _GROUP:
                group = u
            reader[v, u] = group
            prev = u
    return reader


def _parked_counts(tr: Trace, k: _Kinds, parked: set, uses) -> Tuple[int, int]:
    """``(live_peak, shared_slots)`` of ``_park(tr, k, parked, uses)``,
    counted on the statement order :func:`_park` would print, without
    building its graph."""
    pos = {n: i for i, n in enumerate(k.values)}
    reader = _read_groups(parked, pos, uses)
    current: Dict[torch.fx.Node, Tuple[object, object]] = {}
    order: List[Tuple[object, tuple]] = []  # (value defined or None, reads)
    held: Dict[torch.fx.Node, List[int]] = {}  # parked value -> [stash, last read back]

    def read(v, u):
        group = reader[v, u]
        if current[v][0] != group:
            current[v] = (group, ("unstash", v, group))
            order.append((current[v][1], ()))
            held[v][1] = len(order) - 1
        return current[v][1]

    def park(v):
        order.append((None, (v,)))  # the stash, which holds no register
        held[v] = [len(order) - 1] * 2
        current[v] = ("first", v)

    for p in k.inputs:
        if p in parked:
            park(p)
    for n in k.values:
        order.append((n, tuple(read(d, pos[n]) if d in parked else d
                               for d in dict.fromkeys(_reads(n, k)))))
        if n in parked:
            park(n)
    outs = [read(d, len(k.values)) if d in parked else d
            for d in (k.root.get(a, a) for a in tr.graph.graph.output_node().all_input_nodes)]
    first = {p: -1 for p in k.inputs}
    last = dict(first)
    for i, (v, reads) in enumerate(order):
        if v is not None:
            first[v] = last[v] = i
        for d in reads:
            last[d] = max(last.get(d, -1), i)
    for d in outs:
        last[d] = len(order)
    return (_peak([(first[v], max(last[v], first[v])) for v in first], len(order)),
            _peak([tuple(span) for span in held.values()], len(order)))


def _park(tr: Trace, k: _Kinds, parked: set, uses) -> Trace:
    """``tr`` with each value of ``parked`` stored to shared memory right
    after its statement (inputs at the start) and read back before each
    group of its reads that is not within ``_GROUP`` statements of the
    previous read."""
    g = tr.graph.graph
    new = torch.fx.Graph()
    new.set_codegen(g._codegen)
    env: Dict[torch.fx.Node, torch.fx.Node] = {}
    pos = {n: i for i, n in enumerate(k.values)}
    slot: Dict[torch.fx.Node, torch.fx.Node] = {}
    reader = _read_groups(parked, pos, uses)
    current: Dict[torch.fx.Node, Tuple[object, torch.fx.Node]] = {}

    def park(v, node):
        slot[v] = new.call_function(stash, (node,))
        slot[v].meta = dict(v.meta)
        current[v] = ("first", node)

    def read(v, u):
        group = reader[v, u]
        if current[v][0] != group:
            node = new.call_function(unstash, (slot[v],))
            node.meta = dict(v.meta)
            current[v] = (group, node)
        return current[v][1]

    for p in (n for n in g.nodes if n.op == "placeholder"):
        env[p] = new.placeholder(p.name)
        env[p].meta = dict(p.meta)
    for p in k.inputs:
        if p in parked:
            park(p, env[p])
    for n in g.nodes:
        if n.op != "call_function":
            continue
        here = pos.get(n)
        env[n] = new.node_copy(n, lambda a: (
            read(k.root.get(a, a), here) if here is not None
            and k.root.get(a, a) in parked else env[a]))
        if n in parked:
            park(n, env[n])
    end = len(k.values)
    new.output(torch.fx.node.map_arg(
        g.output_node().args[0],
        lambda a: read(k.root.get(a, a), end) if k.root.get(a, a) in parked else env[a]))
    return Trace(torch.fx.GraphModule(tr.graph, new), tr.inputs, tr.outputs,
                 tr.params, tr.fn)


# ------------------------------------------------------------------ printing
# Rules for the aten targets the four traces hold; any other target raises.
_BINARY = {
    "add": "+", "sub": "-", "mul": "*", "div": "/",
    "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "bitwise_and": "&&",
}
_UNARY_FN = {"exp": "xexp", "sqrt": "xsqrt", "tanh": "xtanh"}
_COPIES = {"alias_copy", "expand_copy", "clone", "_to_copy"}
_CONSTANTS = {"zeros", "zeros_like", "ones_like", "full_like", "scalar_tensor"}


def _lit(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if not isinstance(v, (int, float)):
        raise NotImplementedError(f"emit: literal {v!r} of type {type(v)}")
    s = repr(float(v))
    if s in ("inf", "-inf", "nan"):
        raise NotImplementedError(f"emit: literal {v!r}")
    return s


def _op_name(node) -> Tuple[str, str]:
    """("mul", "Tensor") for aten.mul.Tensor; raises outside aten."""
    qual = node.target.name() if hasattr(node.target, "name") else str(node.target)
    ns, _, rest = qual.partition("::")
    if ns != "aten":
        raise NotImplementedError(f"emit: no rule for {node.target}")
    name, _, overload = rest.partition(".")
    return name, overload


def _constant_value(node, name):
    if name in ("zeros", "zeros_like"):
        return 0.0
    if name == "ones_like":
        return 1.0
    if name == "full_like":
        return node.args[1]
    return node.args[0]  # scalar_tensor


class _Printer:
    """Kinds, C names and statements of one traced graph."""

    def __init__(self, tr: Trace):
        self.tr = tr
        self.name: Dict[torch.fx.Node, str] = {}
        self.param: Dict[torch.fx.Node, bool] = {}
        self.consts: Dict[torch.fx.Node, int] = {}  # boundary param -> k index
        self.root: Dict[torch.fx.Node, torch.fx.Node] = {}  # copy -> source
        self.host: List[str] = []
        self.body: List[str] = []
        self.divides = 0  # division statements of the body
        self.reciprocals = 0  # of them, the reciprocals :func:`divide_once` made
        places = [n for n in tr.graph.graph.nodes if n.op == "placeholder"]
        if len(places) != len(tr.inputs):
            raise RuntimeError(f"{len(places)} placeholders for "
                               f"{len(tr.inputs)} input names")
        npar = len(tr.params)
        self.used_params = []
        for i, (node, cname) in enumerate(zip(places, tr.inputs)):
            if i < npar:
                self.param[node] = True
                self.name[node] = cname  # renamed to p[j] below
                if node.users:
                    self.used_params.append((tr.params[i], node))
            else:
                self.param[node] = False
                self.name[node] = cname

    @staticmethod
    def _is_bool(node) -> bool:
        return node.meta["val"].dtype == torch.bool

    def _ctype(self, node) -> str:
        if self.param[node]:
            return "double"
        return "bool" if self._is_bool(node) else "T"

    def arg(self, a, ctx: str) -> str:
        """Render argument ``a`` for a consumer computing in ``ctx``."""
        if isinstance(a, torch.fx.Node):
            if ctx == "double" or not self.param[a]:
                return self.name[a]
            if self._is_bool(a):
                raise NotImplementedError(f"emit: boolean param node {a}")
            a = self.root.get(a, a)
            if a not in self.consts:
                self.consts[a] = len(self.consts)
            return f"k[{self.consts[a]}]"
        lit = _lit(a)
        if ctx == "double" or isinstance(a, bool):
            return lit
        return f"T({lit})"

    def statement(self, node) -> None:
        if node.target is stash:
            self.param[node] = False
            self.name[node] = str(self.slot[node])
            self.body.append(f"xstash(stash, {self.slot[node]}, {self.arg(node.args[0], 'T')});")
            return
        name, overload = ((_name(node), "") if node.target in (unstash, quotient)
                          else _op_name(node))
        deps = [a for a in node.all_input_nodes]
        is_param = bool(deps) and all(self.param[d] for d in deps) \
            and name not in _CONSTANTS
        self.param[node] = is_param
        ctype = "double" if is_param else ("bool" if self._is_bool(node) else "T")
        a = node.args
        kw = dict(node.kwargs)

        def r(x):
            return self.arg(x, ctype)

        if name in _CONSTANTS:
            expr = (_lit(_constant_value(node, name)) if ctype == "bool"
                    else f"T({_lit(_constant_value(node, name))})")
        elif name in _COPIES:
            src = a[0]
            if src.meta["val"].dtype != node.meta["val"].dtype:
                raise NotImplementedError(f"emit: {name} changes the dtype at {node}")
            # a copy is the value it copies: no statement, same name
            self.name[node] = self.name[src]
            self.root[node] = self.root.get(src, src)
            return
        elif name in _BINARY:
            alpha = kw.pop("alpha", 1)
            if alpha != 1 or kw.pop("rounding_mode", None) is not None:
                raise NotImplementedError(f"emit: {node.target} with {node.kwargs}")
            expr = f"{r(a[0])} {_BINARY[name]} {r(a[1])}"
        elif name == "rsub":
            if kw.get("alpha", 1) != 1:
                raise NotImplementedError(f"emit: rsub with {node.kwargs}")
            expr = f"{r(a[1])} - {r(a[0])}"
        elif name == "neg":
            expr = f"-{r(a[0])}"
        elif name == "reciprocal":
            expr = ("1.0" if ctype == "double" else "T(1.0)") + f" / {r(a[0])}"
        elif name in _UNARY_FN:
            fn = f"std::{name}" if ctype == "double" else _UNARY_FN[name]
            expr = f"{fn}({r(a[0])})"
        elif name == "pow" and overload == "Tensor_Scalar":
            expr = self._pow(r(a[0]), a[1], ctype)
        elif name == "tanh_backward":
            one = "1.0" if ctype == "double" else "T(1.0)"
            expr = f"{r(a[0])} * ({one} - {r(a[1])} * {r(a[1])})"
        elif name == "unstash":
            expr = f"xunstash(stash, {self.name[a[0]]})"
        elif name == "quotient":
            expr = f"xdivr({r(a[0])}, {r(a[1])}, {r(a[2])})"
        elif name == "where":
            expr = f"{r(a[0])} ? {r(a[1])} : {r(a[2])}"
        elif name == "clamp_min":
            expr = f"xmax({r(a[0])}, {r(a[1])})"
        elif name == "clamp_max":
            expr = f"xmin({r(a[0])}, {r(a[1])})"
        elif name == "clamp":
            expr = f"xmin(xmax({r(a[0])}, {r(a[1])}), {r(a[2])})"
        else:
            raise NotImplementedError(f"emit: no rule for {node.target}")
        if name in ("div", "reciprocal") and not is_param:
            self.divides += 1
            self.reciprocals += _RECIPROCAL in node.meta
        cname = f"{'h' if is_param else 'v'}{len(self.host if is_param else self.body)}"
        self.name[node] = cname
        (self.host if is_param else self.body).append(
            f"const {ctype} {cname} = {expr};")

    @staticmethod
    def _pow(x: str, e, ctype: str) -> str:
        if e == 1:
            return x
        if e == 2:
            return f"{x} * {x}"
        if e == 3:
            return f"{x} * {x} * {x}"
        if ctype == "double":
            return f"std::pow({x}, {_lit(e)})"
        return f"xpow({x}, T({_lit(e)}))"

    def _slots(self) -> None:
        """A shared-memory slot for each stash: the lowest free one at the
        stash, free again after its last read back."""
        nodes = [n for n in self.tr.graph.graph.nodes if n.op == "call_function"]
        index = {n: i for i, n in enumerate(nodes)}
        self.slot: Dict[torch.fx.Node, int] = {}
        self.slots = 0
        free: List[int] = []
        release: Dict[int, List[int]] = {}
        for i, n in enumerate(nodes):
            if n.target is stash:
                if free:
                    self.slot[n] = free.pop(0)
                else:
                    self.slot[n] = self.slots
                    self.slots += 1
                last = max((index[u] for u in n.users), default=i)
                release.setdefault(last, []).append(self.slot[n])
            free = sorted(free + release.pop(i, []))

    def run(self, param_index: Dict[str, int]) -> None:
        for path, node in self.used_params:
            self.name[node] = f"p[{param_index[path]}]"
        self._slots()
        for node in self.tr.graph.graph.nodes:
            if node.op == "call_function":
                self.statement(node)
            elif node.op not in ("placeholder", "output"):
                raise NotImplementedError(f"emit: graph node {node.op} {node.target}")
        out = torch.utils._pytree.tree_leaves(self.tr.graph.graph.output_node().args[0])
        if len(out) != len(self.tr.outputs):
            raise RuntimeError(f"{len(out)} outputs for {len(self.tr.outputs)} names")
        for dst, src in zip(self.tr.outputs, out):
            self.body.append(f"{dst} = {self.arg(src, 'T')};")
        # host code for the boundary constants, in k order
        for node, j in sorted(self.consts.items(), key=lambda t: t[1]):
            self.host.append(f"k[{j}] = {self.name[node]};")


_SIGNATURE = {
    "tl": ("const T* x, const T* c, const T* r, const T* dx, const T dpaph_sfc,"
           " const T* dr,\n      T* y, T* ry, T* dy, T* dry"),
    "ad": ("const T* x, const T* c, const T* r, const T* s, const T* sr,\n"
           "      T* gx, T& gpaph_sfc, T* gr, T* __restrict__ stash"),
}

_ABOUT = {
    "tl": ("Primal and tangent of one level: torch.func.jvp of level_physics."
           "\n// Inputs: x = the 17 fields (pt pq pqs pap pl pi"
           " plude pmfu pmfd ten_t ten_q ten_l\n// ten_i psupsat plu_k1 paph_lo"
           " paph_hi), c = (ztrpaus, paph_sfc), r = the carry\n// (zrfl zsfl"
           " zcovptot), dx/dpaph_sfc/dr their tangents (ztrpaus has none).\n"
           "// Outputs: y = the 8 level outputs (tenl_t tenl_q tenl_l tenl_i pclc"
           " pcovptot\n// rfln sfln), ry = the new carry, dy/dry their tangents."),
    "ad": ("Primal recompute and transpose of one level: torch.func.vjp of"
           " level_physics.\n// Inputs: x = the 17 fields (pt pq"
           " pqs pap pl pi plude pmfu pmfd ten_t\n// ten_q ten_l ten_i psupsat"
           " plu_k1 paph_lo paph_hi), c = (ztrpaus, paph_sfc),\n// r = the carry"
           " into the level, s = the 8 output cotangents, sr = the\n// new-carry"
           " cotangents.  Outputs: gx = the 17 field cotangents, gpaph_sfc,\n"
           "// gr = the carry-in cotangents (ztrpaus' is dropped)."),
}


def emit_header(kind: str) -> str:
    """The text of the generated header for ``kind`` ("tl" or "ad")."""
    return render_header(kind, {v: trace(kind, *v) for v in VARIANTS})


def render_header(kind: str, traces: Dict[Tuple[bool, bool], Trace]) -> str:
    """The header for ``kind`` from its four traces, keyed by ``(evap,
    lregcl)``: the TL bodies in their traced order, divided once within
    ``TL_LIVE_BUDGET`` (:func:`divide_within`), the AD bodies in the
    schedule of :func:`reschedule` ("stash order" in their comments)."""
    printed = "stash" if kind == "ad" else "trace"
    traces = {v: reschedule(tr) if kind == "ad" else divide_within(tr, TL_LIVE_BUDGET)
              for v, tr in traces.items()}
    printers = {v: _Printer(traces[v]) for v in VARIANTS}
    paths = printers[VARIANTS[0]].tr.params
    used = {p for pr in printers.values() for p, _ in pr.used_params}
    order = [p for p in paths if p in used]
    index = {p: i for i, p in enumerate(order)}
    for pr in printers.values():
        pr.run(index)
    ns = f"cloudsc2_{kind}"
    lines = [
        f"// Generated by `{REGENERATE}` from",
        "// cloudsc2jax_torch/kernels/cloudsc2_kernel.py:level_physics; do not edit.",
        f"// {_ABOUT[kind]}",
        "//",
        "// Level<E, R>::constants runs on the host in double; its k[] values reach",
        "// the kernel rounded to T.  p[] holds the params named in kParamNames.",
        "#pragma once",
        "",
        '#include "cloudsc2_math.cuh"',
        "",
        f"namespace {ns} {{",
        "",
        f"constexpr int kNumParams = {len(order)};",
        f'constexpr const char* kParamNames = "{" ".join(order)}";',
        "constexpr int kMaxConsts = "
        f"{max(len(pr.consts) for pr in printers.values())};",
        "",
        "template <bool EVAP, bool LREGCL>",
        "struct Level;",
    ]
    for evap, lregcl in VARIANTS:
        pr = printers[evap, lregcl]
        flags = f"{'true' if evap else 'false'}, {'true' if lregcl else 'false'}"
        lines += [
            "",
            f"// levapls2 or ldrain1d, lregcl: {flags}"
            f" ({len(pr.body)} statements, live peak {live_peak(pr.tr)},"
            + (f" {pr.slots} shared slots," if kind == "ad" else "")
            + f" {pr.divides} divisions, {pr.reciprocals} reciprocals, {printed} order)",
            "template <>",
            f"struct Level<{flags}> {{",
            f"  static constexpr int kNumConsts = {len(pr.consts)};",
            *([] if kind != "ad" else [
                "  // shared-memory slots per thread, kStashStride values apart",
                f"  static constexpr int kStashSlots = {pr.slots};"]),
            "  // division statements of run(), and of them the reciprocals of",
            "  // divisors that divide more than one numerator",
            f"  static constexpr int kDivides = {pr.divides};",
            f"  static constexpr int kReciprocals = {pr.reciprocals};",
            "",
            "  static void constants(const double* p, double* k) {",
            *(f"    {s}" for s in pr.host),
            "  }",
            "",
            "  template <typename T>",
            "  static __device__ __forceinline__ void run(",
            "      const T* __restrict__ k, const T ceta_k, const T zscalm_k,"
            " const bool not_last,",
            f"      {_SIGNATURE[kind]}) {{",
            *(f"    {s}" for s in pr.body),
            "  }",
            "};",
        ]
    lines += ["", f"}}  // namespace {ns}", ""]
    return "\n".join(lines)


def main() -> int:
    for kind, path in HEADERS.items():
        text = emit_header(kind)
        path.write_text(text)
        print(f"wrote {path} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
