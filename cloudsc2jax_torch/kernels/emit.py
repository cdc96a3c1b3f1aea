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
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ..constants import Params
from .cloudsc2_kernel import level_physics

__all__ = ["HEADERS", "REGENERATE", "Trace", "VARIANTS", "emit_header", "main",
           "param_value", "render_header", "trace", "trace_params"]

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
        name, overload = _op_name(node)
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

    def run(self, param_index: Dict[str, int]) -> None:
        for path, node in self.used_params:
            self.name[node] = f"p[{param_index[path]}]"
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
           "      T* gx, T& gpaph_sfc, T* gr"),
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
    lregcl)``."""
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
            f" ({len(pr.body)} statements)",
            "template <>",
            f"struct Level<{flags}> {{",
            f"  static constexpr int kNumConsts = {len(pr.consts)};",
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
