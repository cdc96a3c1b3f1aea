"""The derivative emitter that writes the TL and AD kernels' level bodies.

The eight traces (TL and AD, each with ``levapls2 or ldrain1d`` and
``lregcl`` off and on) are made once for the module, on the CPU in float64.  The tests hold:

* both generated headers byte for byte against what the emitter writes
  now, so an edit of ``level_physics`` that is not regenerated fails here;
* each traced graph against the function it traced (``torch.func.jvp`` /
  ``torch.func.vjp`` of ``level_physics``) on fixture columns (the trace
  saw random values; the graph keeps the trace's width) and with the
  fixture's params, to 1e-15 relative: the trace is general in the data
  and in every param;
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
    not see, to 1e-15 of each output's max."""
    tr = traces[kind][evap, lregcl]
    args = _level_args(tr, kind, fixture_params, ncol=emit._TRACE_WIDTH)
    got = torch.utils._pytree.tree_leaves(tr.graph(*args))
    want = torch.utils._pytree.tree_leaves(tr.fn(*args))
    assert len(got) == len(want) == len(tr.outputs)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a - b).abs().max()) / scale <= 1e-15


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
