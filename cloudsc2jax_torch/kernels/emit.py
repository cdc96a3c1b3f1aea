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
registers.  No statement is computed twice, and the derivative is still
the traced one: the rescheduled graph is a graph of the same aten ops and
identities, held to the traced function by the tests.  (Recomputing the
long-lived values near their reads instead bought the same registers for
~1.75x the arithmetic and ran slower on the card: PERF.md.)  The TL
bodies keep the traced order: their peak is ~60 values.
"""

from __future__ import annotations

import dataclasses
import pathlib
import weakref
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ..constants import Params
from .cloudsc2_kernel import level_physics

__all__ = ["HEADERS", "LIVE_BUDGET", "REGENERATE", "Trace",
           "VARIANTS", "emit_header", "live_peak", "main", "param_value",
           "render_header", "reschedule", "shared_slots", "stash", "trace",
           "trace_params", "unstash"]

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
    if node.target is stash:
        return "stash"
    if node.target is unstash:
        return "unstash"
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


def _peak(spans, n: int) -> int:
    delta = [0] * (n + 3)
    for start, stop in spans:
        delta[start + 1] += 1
        delta[stop + 2] -= 1
    peak = live = 0
    for step in delta:
        live += step
        peak = max(peak, live)
    return peak


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


def reschedule(tr: Trace) -> Trace:
    """``tr``, an AD trace, in the order the kernel runs it: the primal
    statements sunk to the transpose's first read (:func:`_sink`), then as
    few of the longest-lived values parked in shared memory as bring the
    registers' live peak within ``LIVE_BUDGET`` (:func:`_park`)."""
    if tr.graph in _SCHEDULED:
        return _SCHEDULED[tr.graph]
    sunk = _sink(tr)
    k = _kinds(sunk)
    spans = _lifetimes(sunk, k)
    uses: Dict[torch.fx.Node, List[int]] = {v: [] for v in spans}
    pos = {n: i for i, n in enumerate(k.values)}
    for n in k.values:
        for d in set(_reads(n, k)):
            if d in uses:
                uses[d].append(pos[n])
    end = len(k.values)
    for d in sunk.graph.graph.output_node().all_input_nodes:
        d = k.root.get(d, d)
        if d in uses:
            uses[d].append(end)

    def gap(v):
        marks = [spans[v][0], *sorted(set(uses[v]))]
        return max((b - a for a, b in zip(marks, marks[1:])), default=0)

    order = sorted((v for v in spans if v.meta["val"].dtype != torch.bool
                    and gap(v) > _GROUP),
                   key=lambda v: (-gap(v), spans[v][0]))
    for n in range(0, len(order) + 5, 5):
        parked = _park(sunk, k, set(order[:n]), uses)
        if live_peak(parked) <= LIVE_BUDGET:
            break
    _SCHEDULED[tr.graph] = parked
    return parked


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
    # read -> the value's register copy it reads, per parked value
    reader: Dict[Tuple[torch.fx.Node, int], str] = {}
    for v in parked:
        start = pos.get(v, -1)
        marks = sorted(set(uses[v]))
        prev = start
        group = "first"
        for u in marks:
            if u - prev > _GROUP:
                group = u
            reader[v, u] = group
            prev = u
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
        name, overload = ("unstash", "") if node.target is unstash else _op_name(node)
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
    lregcl)``: the TL bodies in their traced order, the AD bodies in the
    schedule of :func:`reschedule` ("stash order" in their comments)."""
    printed = "stash" if kind == "ad" else "trace"
    if kind == "ad":
        traces = {v: reschedule(tr) for v, tr in traces.items()}
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
            + f" {printed} order)",
            "template <>",
            f"struct Level<{flags}> {{",
            f"  static constexpr int kNumConsts = {len(pr.consts)};",
            *([] if kind != "ad" else [
                "  // shared-memory slots per thread, kStashStride values apart",
                f"  static constexpr int kStashSlots = {pr.slots};"]),
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
