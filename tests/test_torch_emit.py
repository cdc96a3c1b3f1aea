"""The derivative emitter that writes the TL and AD kernels' level bodies.

The eight traces (TL and AD, each with ``levapls2 or ldrain1d`` and
``lregcl`` off and on) are made once for the module, on the CPU in float64.  The tests hold:

* both generated headers byte for byte against what the emitter writes
  now, so an edit of ``level_physics`` that is not regenerated fails here;
* each traced graph, and each TL graph as it is printed (one division
  per divisor, :func:`emit.divide_within`), against the function it
  traced (``torch.func.jvp`` / ``torch.func.vjp`` of ``level_physics``)
  on fixture columns (the trace saw random values; the graph keeps the
  trace's width) and with the fixture's params, to 1e-15 relative: the
  trace is general in the data and in every param;
* the AD bodies' schedule (:func:`emit.reschedule`: primal statements
  sunk to their first read, the longest-lived values parked in shared
  memory) against the traced function to 1e-15, its registers' live peak
  within the budget (at most 100 values for ``Level<false, *>``, 120 for
  ``Level<true, *>``, from 183-224 in the traced order), every traced
  statement computed once, and its shared-memory slots held without
  overlap; the printed TL bodies' live peak within ``emit.TL_LIVE_BUDGET``;
* every printed body dividing once per divisor, by no param and no
  literal, its header's ``kDivides`` and ``kReciprocals`` its own;
* the headers free of any value of the fixture's params;
* an aten op without a rule raising instead of vanishing.

The file imports no JAX.
"""

import ast
import inspect
import pathlib
import re

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from cloudsc2jax_torch.kernels import cloudsc2_kernel, emit
from cloudsc2jax_torch.physics import cloudsc2 as physics_cloudsc2
from cloudsc2jax_torch.state import Cloudsc2State

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def traces():
    return {kind: {v: emit.trace(kind, *v) for v in emit.VARIANTS}
            for kind in ("tl", "ad")}


@pytest.fixture(scope="module")
def fixture_params():
    return Cloudsc2State.load(FIXTURES / "input.npz").params


@pytest.mark.parametrize("kind", ["tl", "ad"])
def test_header_regenerates_byte_for_byte(traces, kind):
    text = emit.render_header(kind, traces[kind])
    assert text.startswith(f"// Generated by `{emit.REGENERATE}`")
    assert text == emit.HEADERS[kind].read_text(), (
        f"{emit.HEADERS[kind].name} is stale: run {emit.REGENERATE}")
    for evap, lregcl in emit.VARIANTS:
        flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
        assert f"struct Level<{flags}> {{" in text


def _level_args(tr, kind, params, k: int = 60, ncol: int = 16):
    """Arguments of the traced function at level ``k`` of ``ncol`` fixture
    columns, with the fixture's params, seeded carries and seeded
    tangents or cotangents."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inp = st.device_kernel_inputs(ncol, dtype=torch.float64, device="cpu", pqs=True)
    pre = cloudsc2_kernel.kernel_prelude(inp, params)
    nlev = inp.pt.shape[0]
    x = tuple(getattr(inp, n)[k] for n in cloudsc2_kernel._LEVEL_FIELDS) + (
        inp.plu[k + 1], inp.paph[k], inp.paph[k + 1])
    c = (pre.ztrpaus, pre.paph_sfc)
    gen = torch.Generator().manual_seed(k)

    def rand(scale):
        return scale * torch.rand(ncol, generator=gen, dtype=torch.float64)

    r = (rand(2e-4), rand(2e-4), rand(1.0))
    pvals = tuple(torch.tensor(emit.param_value(params, p), dtype=torch.float64)
                  for p in tr.params)
    head = (pvals, pre.ceta[k], pre.zscalm[k], torch.tensor(k < nlev - 1))
    if kind == "tl":
        return head + (x, c, r, tuple(0.01 * v * (1 + rand(1.0)) for v in x),
                       0.01 * c[1], tuple(rand(1e-6) for _ in r))
    return head + (x, c, r, tuple(rand(1.0) - 0.5 for _ in range(8)),
                   tuple(rand(1.0) - 0.5 for _ in r))


@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("evap", [False, True])
@pytest.mark.parametrize("kind", ["tl", "ad"])
def test_traced_graph_computes_the_traced_function(traces, fixture_params, kind,
                                                   evap, lregcl):
    """The graph the header is printed from against ``torch.func.jvp`` /
    ``vjp`` of ``level_physics`` itself, on data and params the trace did
    not see, to 1e-15 of each output's max; for the TL also the graph as it
    is printed, divided once per divisor (:func:`emit.divide_within`)."""
    tr = traces[kind][evap, lregcl]
    graphs = [tr] + ([emit.divide_within(tr, emit.TL_LIVE_BUDGET)] if kind == "tl" else [])
    args = _level_args(tr, kind, fixture_params, ncol=emit._TRACE_WIDTH)
    want = torch.utils._pytree.tree_leaves(tr.fn(*args))
    for g in graphs:
        got = torch.utils._pytree.tree_leaves(g.graph(*args))
        assert len(got) == len(want) == len(tr.outputs)
        for a, b in zip(got, want):
            scale = max(float(b.abs().max()), 1e-300)
            assert float((a - b).abs().max()) / scale <= 1e-15


@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("evap", [False, True])
def test_rescheduled_graph_computes_the_traced_function(traces, fixture_params,
                                                       evap, lregcl):
    """The AD body as it is printed (primal statements sunk, values parked
    in shared memory and read back) against ``torch.func.vjp`` of
    ``level_physics``, to 1e-15 of each output's max."""
    tr = emit.reschedule(traces["ad"][evap, lregcl])
    assert tr.graph is not traces["ad"][evap, lregcl].graph
    args = _level_args(tr, "ad", fixture_params, ncol=emit._TRACE_WIDTH)
    got = torch.utils._pytree.tree_leaves(tr.graph(*args))
    want = torch.utils._pytree.tree_leaves(tr.fn(*args))
    assert len(got) == len(want) == len(tr.outputs)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a - b).abs().max()) / scale <= 1e-15


def _quotients(tr):
    """The runtime divisions of a traced body (``div`` and
    ``reciprocal`` statements that read a value), keyed by the values (or
    literals) they divide, copies followed to what they copy: ``{divisor:
    {numerator: [statements]}}``, a reciprocal's numerator ``1.0``."""
    k = emit._kinds(tr)
    out = {}
    for n in k.values:
        if n.target is torch.ops.aten.reciprocal.default:
            num, div = 1.0, n.args[0]
        elif n.target is torch.ops.aten.div.Tensor:
            num, div = n.args
        else:
            continue
        num, div = (k.root.get(a, a) for a in (num, div))
        out.setdefault(div, {}).setdefault(num, []).append(n)
    return out, k


def _division_counts(traced):
    """From a traced body: the runtime divisors (each divided once
    after :func:`emit.divide_once`), those of two numerators or more (each
    given a reciprocal), the quotients printed more than once, merged, and
    those of a repeated divisor that are its reciprocal, merged into it."""
    quotients, k = _quotients(traced)
    runtime = {d: q for d, q in quotients.items()
               if isinstance(d, torch.fx.Node) and d not in k.params}
    repeated = [q for q in runtime.values() if len(q) > 1]
    twice = sum(len(ns) - 1 for q in quotients.values() for ns in q.values())
    ones = sum(1.0 in q for q in repeated)
    return len(runtime), repeated, twice, ones


@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("evap", [False, True])
def test_rescheduled_body_fits_its_budget(traces, evap, lregcl):
    """The printed AD body holds at most ``emit.LIVE_BUDGET`` values in
    registers (100 at most for ``Level<false, *>``, 120 for ``Level<true,
    *>``; 183-224 in the traced order), computes every traced statement
    once and no more: the traced statements, less the quotients printed
    twice and the reciprocals of a repeated divisor, each merged into one
    statement, plus one reciprocal per repeated divisor, less the few primal
    statements no transpose statement reads, whose values only lend a
    literal its shape; it needs at most twice the traced statements, and
    its header states its live peak, shared slots, divisions and
    reciprocals; the TL body as it is printed (its traced order, divided
    once per divisor) holds at most ``emit.TL_LIVE_BUDGET`` (64) values,
    as its header states."""
    traced = traces["ad"][evap, lregcl]
    tr = emit.reschedule(traced)
    peak, traced_peak = emit.live_peak(tr), emit.live_peak(traced)
    assert peak <= emit.LIVE_BUDGET <= (120 if evap else 100) < traced_peak
    k, k0 = emit._kinds(tr), emit._kinds(traced)
    _, repeated, twice, ones = _division_counts(traced)
    ops = [n for n in k.values if n.target not in (emit.stash, emit.unstash)]
    once = len(k0.values) - twice - ones + len(repeated)
    assert once - 10 <= len(ops) <= once  # none recomputed
    assert len(k.values) <= 2 * len(k0.values)
    slots = emit.shared_slots(tr)
    assert 0 < slots * 4 * 128 <= 232_448 // 3 - 1024  # 3 f32 blocks fit an SM
    flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
    ad = emit.HEADERS["ad"].read_text()
    assert re.search(rf"lregcl: {flags} \((\d+) statements, live peak {peak}, "
                     rf"{slots} shared slots, \d+ divisions, \d+ reciprocals, "
                     rf"stash order\)", ad)
    tl_peak = emit.live_peak(emit.divide_within(traces["tl"][evap, lregcl],
                                                emit.TL_LIVE_BUDGET))
    assert tl_peak <= emit.TL_LIVE_BUDGET == 64
    assert re.search(rf"lregcl: {flags} \(\d+ statements, live peak {tl_peak}, "
                     rf"\d+ divisions, \d+ reciprocals, trace order\)",
                     emit.HEADERS["tl"].read_text())


def _variant_body(text, evap, lregcl):
    flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
    return re.search(rf"lregcl: {flags} (.*?)\n}};", text, re.S).group(1)


@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("evap", [False, True])
@pytest.mark.parametrize("kind", ["tl", "ad"])
def test_ad_body_divides_once_per_divisor(traces, kind, evap, lregcl):
    """Each printed body, AD and TL, divides by each value it computes or
    reads at most once (in the AD a value read back from shared memory is
    the value parked), and by no param and no literal; a divisor of two
    numerators or more is divided once, into its reciprocal, from which each
    of its other quotients is formed (``xdivr``), but in a TL body the
    divisors :func:`emit.divide_within` keeps, whose reciprocals would lift
    its live peak above ``emit.TL_LIVE_BUDGET``, keep their divisions.  The
    header's ``kDivides`` and ``kReciprocals`` are the printed division
    statements and the reciprocals of repeated divisors: in
    ``Level<false, true>``, the body the stream and standard cells run, 28
    and 19 in the AD (93 divisions in the trace), 29 and 20 in the TL (61)."""
    traced = traces[kind][evap, lregcl]
    tr = (emit.reschedule(traced) if kind == "ad"
          else emit.divide_within(traced, emit.TL_LIVE_BUDGET))
    quotients, k = _quotients(tr)
    parked = {}
    for n in tr.graph.graph.nodes:
        if n.target is emit.stash:
            parked[n] = k.root.get(n.args[0], n.args[0])
        elif n.target is emit.unstash:
            parked[n] = parked[n.args[0]]
    divisors = [parked.get(d, d) for d in quotients]
    assert len(divisors) == len(set(divisors))
    assert all(isinstance(d, torch.fx.Node) and d not in k.params for d in divisors)
    kept = {d: q for d, q in quotients.items() if sum(len(ns) for ns in q.values()) > 1}
    assert all(len(ns) == 1 for q in quotients.values() for ns in q.values())
    if kind == "ad" or emit.live_peak(emit.divide_once(traced)) <= emit.TL_LIVE_BUDGET:
        assert not kept

    runtime, repeated, _, _ = _division_counts(traced)
    body = _variant_body(emit.HEADERS[kind].read_text(), evap, lregcl)
    statements = re.findall(r"const T v\d+ = ([^;]*);", body)
    printed = [s for s in statements if " / " in s]
    assert not any(re.search(r" / (k\[|T\()", s) for s in printed)
    divides = int(re.search(r"kDivides = (\d+);", body).group(1))
    reciprocals = int(re.search(r"kReciprocals = (\d+);", body).group(1))
    assert f"{divides} divisions, {reciprocals} reciprocals" in body
    assert divides == len(printed) == runtime + sum(len(q) - 1 for q in kept.values())
    assert reciprocals == len(repeated) - len(kept)
    assert sum(s.startswith("xdivr(") for s in statements) == sum(
        len(q) - (1.0 in q) for q in repeated) - sum(len(q) - (1.0 in q) for q in kept.values())
    if (evap, lregcl) == (False, True):
        assert (divides, reciprocals) == {"ad": (28, 19), "tl": (29, 20)}[kind]
        assert sum(len(ns) for q in _quotients(traced)[0].values()
                   for ns in q.values()) == {"ad": 93, "tl": 61}[kind]


def test_quotient_is_the_correctly_rounded_division():
    """``emit.quotient``, the graph's form of ``xdivr``: the product with
    the correctly rounded reciprocal and one step on its exact residual
    give ``a / b`` bit for bit, where the product alone is off by an ulp
    in a share of cases."""
    gen = torch.Generator().manual_seed(3)
    a = torch.rand(4096, generator=gen, dtype=torch.float64) * 10.0 ** torch.randint(
        -8, 8, (4096,), generator=gen)
    b = torch.rand(4096, generator=gen, dtype=torch.float64) + 2.0 ** torch.randint(
        -30, 30, (4096,), generator=gen)
    rb = torch.reciprocal(b)
    assert torch.equal(emit.quotient(a, b, rb), a / b)
    assert not torch.equal(a * rb, a / b)


@pytest.mark.parametrize("evap", [False, True])
def test_parked_counts_count_the_printed_order(traces, evap):
    """``emit._parked_counts``, which :func:`emit.reschedule` asks while it
    chooses what to park, are ``live_peak`` and ``shared_slots`` of the
    body ``_park`` prints, for no value parked, for the longest-lived
    values and for every value that may be parked."""
    sunk = emit._sink(emit.divide_once(traces["ad"][evap, True]))
    k = emit._kinds(sunk)
    pos = {n: i for i, n in enumerate(k.values)}
    uses = emit._uses(sunk, k)
    values = [v for v in uses if v.meta["val"].dtype != torch.bool and uses[v]]
    longest = sorted(values, key=lambda v: pos.get(v, -1) - max(uses[v]))
    for parked in (set(), set(longest[:60]), set(values)):
        printed = emit._park(sunk, k, parked, uses)
        assert emit._parked_counts(sunk, k, parked, uses) == (
            emit.live_peak(printed), emit.shared_slots(printed))


@pytest.mark.parametrize("evap", [False, True])
def test_parked_values_keep_their_slots(traces, evap):
    """Each parked value is read back and holds its shared-memory slot
    from its store to its last read; no two values share a slot at once,
    and the printer uses no more slots than are parked at once."""
    tr = emit.reschedule(traces["ad"][evap, True])
    pr = emit._Printer(tr)
    pr._slots()
    nodes = [n for n in tr.graph.graph.nodes if n.op == "call_function"]
    index = {n: i for i, n in enumerate(nodes)}
    held = {}
    for n, slot in pr.slot.items():
        assert n.users and all(u.target is emit.unstash for u in n.users)
        span = (index[n], max(index[u] for u in n.users))
        for other in held.get(slot, []):
            assert span[0] > other[1] or span[1] < other[0]
        held.setdefault(slot, []).append(span)
    assert pr.slots == emit.shared_slots(tr)
    text = emit.HEADERS["ad"].read_text()
    assert "xstash(stash, " in text and "xunstash(stash, " in text
    assert "stash" not in emit.HEADERS["tl"].read_text().split("#pragma once")[1]


def _source_literals():
    """repr of every float literal in the level body's source."""
    found = set()
    for obj in (cloudsc2_kernel, physics_cloudsc2):
        for node in ast.walk(ast.parse(inspect.getsource(obj))):
            if isinstance(node, ast.Constant) and isinstance(node.value, float):
                found.add(repr(node.value))
    return found


def test_headers_hold_no_param_value(fixture_params):
    """Every param the level reads reaches the kernel at launch: no value
    of the fixture's params is printed into the generated source, except
    one that the level body's own source also writes as a literal."""
    allowed = _source_literals()
    for kind, path in emit.HEADERS.items():
        text = path.read_text()
        names = re.search(r'kParamNames = "([^"]*)"', text).group(1).split()
        assert names and set(names) <= set(emit._param_paths(fixture_params))
        literals = set(re.findall(r"(?<![\w.\[])(-?\d+\.\d*(?:e[-+]?\d+)?)", text))
        for p in names:
            v = emit.param_value(fixture_params, p)
            for s in {repr(v), repr(float(torch.tensor(v, dtype=torch.float32)))}:
                assert s not in literals or s in allowed, (kind, p, s)


def test_unknown_op_raises():
    gm = make_fx(lambda x: torch.sin(x) * 2.0)(torch.ones(4, dtype=torch.float64))
    tr = emit.Trace(gm, ["x[0]"], ["y[0]"], [], None)
    with pytest.raises(NotImplementedError, match="sin"):
        emit._Printer(tr).run({})
