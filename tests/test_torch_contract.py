"""The standard contract's assembly: the sweeps write their flux rows into
the contract's flux fields, and one assembly finishes them
(``kernels.cloudsc2_kernel.assemble_contract``: on the card one launch of
``csrc/cloudsc2_contract.cu``, on the CPU the plain expressions
``plain_contract``), with the reverse sweep's seeds for a TL image.

On the CPU: ``plain_contract``, in both forms, is bit for bit the
expressions the port assembled with before (a zero row, ``torch.cat``,
``-x * L``; ``seed_streams`` of the assembled tangent), ``-0.0`` top rows
included; the sweeps write the outputs they are given; the standard paths
assemble in place and ``run_tlad(backend="kernels")`` assembles nothing of
its forward-checkpoint sweep, with the same results.  On a card (marked
``cuda``): the kernel against those expressions on the card, bit for bit,
in both forms, both dtypes and a column count that is neither a multiple of
4 nor of the block; every standard path against its composition from the
sweeps and those expressions; the launches a call issues.

The file imports neither JAX nor ``conftest``::

    python -m pytest tests/test_torch_contract.py -q -p no:cacheprovider --noconftest
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from cloudsc2jax_torch import drivers
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Outputs
from cloudsc2jax_torch.state import Cloudsc2State

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = [torch.float32, torch.float64]
# neither a multiple of 4 (a 16 B pack of f32) nor of the block
RAGGED = 5001


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _before_unblock(out, params):
    """The assembly as the port wrote it before the contract's kernel,
    levels-major: the reference of every comparison here."""
    top = torch.zeros_like(out.rfln[:1])
    pfplsl = torch.cat([top, out.rfln], dim=0)
    pfplsn = torch.cat([top, out.sfln], dim=0)
    return Cloudsc2Outputs(
        tenl_t=out.tenl_t, tenl_q=out.tenl_q, tenl_l=out.tenl_l,
        tenl_i=out.tenl_i, pclc=out.pclc, pfplsl=pfplsl, pfplsn=pfplsn,
        pfhpsl=-pfplsl * params.yomcst.rlvtt, pfhpsn=-pfplsn * params.yomcst.rlstt,
        pcovptot=out.pcovptot)


def _before_seeds(d, params):
    cst = params.yomcst
    return (d.pfplsl[1:] - cst.rlvtt * d.pfhpsl[1:],
            d.pfplsn[1:] - cst.rlstt * d.pfhpsn[1:])


def _same(got, want, what):
    """Bit for bit, the sign of every zero included."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        assert torch.equal(a, b), (what, i)
        assert torch.equal(torch.signbit(a), torch.signbit(b)), (what, i)


def _streams(nlev, ncol, dtype, device, seed=0):
    """8 raw streams with zeros (both signs) among the fluxes."""
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(nlev, ncol, generator=g, dtype=torch.float64) * 1e-4
          for _ in kmod.Cloudsc2StreamOutputs._fields]
    for x in xs[-2:]:
        x[:, ::7] = 0.0
        x[:, 3::11] = -0.0
    return kmod.Cloudsc2StreamOutputs(*(x.to(dtype=dtype, device=device) for x in xs))


def _in_place(out):
    """``out`` with its flux streams moved into rows 1.. of new flux
    fields, as a sweep given :func:`flux_slots` leaves them."""
    flux = kmod.flux_rows(out.rfln)
    for slot, x in zip(kmod.flux_slots(flux).values(), (out.rfln, out.sfln)):
        slot.copy_(x)
    return out._replace(**kmod.flux_slots(flux)), flux


def _check_top_rows(res):
    for name in ("pfplsl", "pfplsn"):
        row = getattr(res, name)[0]
        assert not torch.signbit(row).any() and not row.any(), name
    for name in ("pfhpsl", "pfhpsn"):
        row = getattr(res, name)[0]
        assert torch.signbit(row).all() and not row.any(), name


# ------------------------------------------------------------------ the CPU
@pytest.fixture(scope="module")
def small():
    return Cloudsc2State.synthetic(ngptot=24, nlev=13, seed=7)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_contract_is_unblock_outputs_and_seed_streams(small, dtype, in_place):
    """``plain_contract`` in either form against the expressions the port
    assembled with before, and its seeds against ``seed_streams`` of the
    assembled tangent, bit for bit; the top rows +0 and -0.0."""
    p = small.params
    out = _streams(13, 23, dtype, "cpu")
    want = _before_unblock(out, p)
    flux = None
    if in_place:
        out, flux = _in_place(out)
    res, sd = kmod.plain_contract(out, p, flux=flux, seeds=True)
    _same(res, want, "outputs")
    _check_top_rows(res)
    seeds = tk.seed_streams(want, p, levels_major=True)
    _same(sd, (seeds.rfln, seeds.sfln), "seeds")
    _same(sd, _before_seeds(want, p), "seeds")
    assert kmod.plain_contract(out, p, flux=flux)[1] is None
    if in_place:
        assert res.pfplsl.data_ptr() == flux.pfplsl.data_ptr()


@pytest.mark.parametrize("dtype", DTYPES)
def test_unblock_outputs_is_the_plain_contract(small, dtype):
    """``unblock_outputs`` on streams it did not allocate: the copy form,
    ``(ncol, nlev+1)`` views, or the levels-major tensors."""
    out = _streams(13, 23, dtype, "cpu", seed=1)
    want = _before_unblock(out, small.params)
    _same(kmod.unblock_outputs(out, small.params, levels_major=True), want, "lm")
    got = kmod.unblock_outputs(out, small.params)
    _same(got, tuple(x.T for x in want), "views")


@pytest.mark.parametrize("sweep", ["nl", "fwd_ckpt", "tl_din"])
def test_sweeps_write_the_outputs_they_are_given(small, sweep):
    """Each sweep the standard contract runs writes its flux rows into the
    rows 1.. given (``flux_slots``), with the values it returns without."""
    p = small.params
    x = small.device_kernel_inputs(23, dtype=torch.float64, device="cpu", pqs=True)
    flux, d_flux = kmod.flux_rows(x.pt), kmod.flux_rows(x.pt)
    slots = kmod.flux_slots(flux)
    d = type(x)(*(0.01 * v for v in x))

    def run(out=None):
        if sweep == "nl":
            return (kmod.cloudsc2_nl(x, p, out=out),)
        if sweep == "fwd_ckpt":
            return kmod.cloudsc2_fwd_ckpt(x, p, out=out)[:1]
        return tk.cloudsc2_tl_din(x, d, p, out=out)

    if sweep == "tl_din":
        slots = {**slots, **kmod.flux_slots(d_flux, "d_")}
    got, want = run(slots), run()
    for g, w in zip(got, want):
        _same(g, w, sweep)
    assert got[0].rfln.data_ptr() == flux.pfplsl[1].data_ptr()
    assert got[0].sfln.data_ptr() == flux.pfplsn[1].data_ptr()
    if sweep == "tl_din":
        assert got[1].rfln.data_ptr() == d_flux.pfplsl[1].data_ptr()


def test_outputs_given_are_checked(small):
    p = small.params
    x = small.device_kernel_inputs(23, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="no output"):
        kmod.cloudsc2_nl(x, p, out={"pfplsl": x.pt.clone()})
    with pytest.raises(ValueError, match="shape"):
        kmod.cloudsc2_nl(x, p, out={"rfln": x.paph.clone()})
    with pytest.raises(ValueError, match="float32"):
        kmod.cloudsc2_nl(x, p, out={"rfln": x.pt.float()})
    out = _streams(137, 23, torch.float64, "cpu")
    with pytest.raises(ValueError, match="rows 1"):
        kmod.assemble_contract(out, p, flux=kmod.flux_rows(out.rfln))


def _counting(monkeypatch, name, modules):
    calls = []
    fn = getattr(modules[0], name)

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    for module in modules:
        monkeypatch.setattr(module, name, counted)
    return calls


def _unit_before(x, p):
    """``run_tlad(backend="kernels")`` composed as the port ran it before:
    the TL sweep, both contracts and the seeds by the expressions above,
    the forward-checkpoint and reverse sweeps, levels-major."""
    lm = tk.to_levels_major(x)
    d = type(lm)(*(drivers.DSCALE * v for v in lm))
    pre = kmod.kernel_prelude(lm, p)
    out, dout = tk.cloudsc2_tl_din(lm, d, p, lregcl=True, pre=pre)
    o, do = _before_unblock(out, p), _before_unblock(dout, p)
    seeds = dout._replace(**dict(zip(("rfln", "sfln"), _before_seeds(do, p))))
    fwd, ckpts = kmod.cloudsc2_fwd_ckpt(lm, p) if lm.pt.is_cuda else (
        kmod.cloudsc2_fwd_ckpt_reference(lm, p, pre=pre))
    adj = tk.cloudsc2_ad(lm, seeds, ckpts, p, fold_seeds=False, pre=pre)
    return o, do, adj


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_tlad_assembles_no_forward_outputs(small, monkeypatch, dtype):
    """The unit assembles two contracts (its TL's primal, and its tangent
    with the seeds) and never calls ``unblock_outputs``: the forward sweep's
    outputs are dropped unassembled; the triple is what it was."""
    unblocks = _counting(monkeypatch, "unblock_outputs", (kmod, drivers))
    assembles = _counting(monkeypatch, "assemble_contract", (kmod, tk))
    x = small.device_inputs(23, dtype=dtype, device="cpu")
    got = drivers.run_tlad(x, small.params, backend="kernels")
    assert unblocks == []
    assert [(c["flux"] is not None, c.get("seeds", False)) for c in assembles] == [
        (True, False), (True, True)]
    for name, g, w in zip(("outputs", "tangents", "adjoints"), got,
                          _unit_before(x, small.params)):
        _same(tuple(g), tuple(v.T for v in w), name)


@pytest.mark.parametrize("levels_major", [False, True])
def test_drop_ins_assemble_in_place(small, monkeypatch, levels_major):
    """``cloudsc2_kernel_tl`` assembles its two contracts and
    ``cloudsc2_kernel_ad`` its forward sweep's in place, bit for bit the
    expressions above, in either layout."""
    assembles = _counting(monkeypatch, "assemble_contract", (kmod, tk))
    p = small.params
    lm = small.device_kernel_inputs(23, dtype=torch.float32, device="cpu", pqs=True)
    d = type(lm)(*(0.01 * v for v in lm))
    x, dx = (lm, d) if levels_major else (type(lm)(*(v.T for v in lm)),
                                          type(d)(*(v.T for v in d)))
    o, do = tk.cloudsc2_kernel_tl(x, dx, p, lregcl=True, levels_major=levels_major)
    out, adj = tk.cloudsc2_kernel_ad(x, do, p, lregcl=True, levels_major=levels_major)
    assert [c["flux"] is not None for c in assembles] == [True] * 3
    t = (lambda v: v) if levels_major else (lambda v: v.T)
    ws, wd = tk.cloudsc2_tl_din(lm, d, p, lregcl=True)
    _same(tuple(o), tuple(t(v) for v in _before_unblock(ws, p)), "tl outputs")
    _same(tuple(do), tuple(t(v) for v in _before_unblock(wd, p)), "tl tangents")
    fwd, _ = kmod.cloudsc2_fwd_ckpt_reference(lm, p)
    _same(tuple(out), tuple(t(v) for v in _before_unblock(fwd, p)), "ad outputs")


def test_contract_bytes():
    """The kernel's bytes in F, one (nlev, ncol) field: 4 F in place, 6 F
    as a copy, 2 F more with seeds, each plus its (nlev+1)th rows; the plain
    passes 12 F and 10 F more."""
    nlev, ncol, size = 137, 327_680, 4
    row = ncol * size
    f = nlev * row

    def b(**kw):
        return kmod.contract_bytes(nlev, ncol, size, **kw)

    assert b(in_place=True, seeds=False, kernel=True) == 4 * f + 4 * row
    assert b(in_place=True, seeds=True, kernel=True) == 6 * f + 4 * row
    assert b(in_place=False, seeds=False, kernel=True) == 6 * f + 4 * row
    assert b(in_place=False, seeds=False, kernel=False) == 12 * f + 13 * row
    assert b(in_place=False, seeds=True, kernel=False) == 22 * f + 13 * row
    assert b(in_place=True, seeds=True, kernel=False) == 18 * f + 10 * row


# ----------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("seeds", [False, True])
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("ncol", [RAGGED, 4096])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_contract_kernel_is_the_plain_expressions(dtype, ncol, in_place, seeds):
    """The kernel against the expressions on the card, bit for bit, in both
    forms, with and without seeds; 5,001 columns run single values, 4,096
    the 16 B packs; one launch, counted."""
    _need_cuda()
    p = Cloudsc2State.synthetic(ngptot=4, nlev=137).params
    out = _streams(137, ncol, dtype, "cuda", seed=ncol)
    want = _before_unblock(out, p)
    want_seeds = _before_seeds(want, p)
    flux = None
    if in_place:
        out, flux = _in_place(out)
    launches = kmod.assemble_contract.launches
    res, sd = kmod.assemble_contract(out, p, flux=flux, seeds=seeds)
    torch.cuda.synchronize()
    assert kmod.assemble_contract.launches == launches + 1
    _same(res, want, "outputs")
    _check_top_rows(res)
    if seeds:
        _same(sd, want_seeds, "seeds")
    else:
        assert sd is None
    if in_place:
        assert res.pfplsl.data_ptr() == flux.pfplsl.data_ptr()
    plain, plain_seeds = kmod.plain_contract(_streams(137, ncol, dtype, "cuda",
                                                      seed=ncol), p, seeds=True)
    _same(res, plain, "plain")
    _same(plain_seeds, want_seeds, "plain seeds")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_standard_paths_are_bit_for_bit(dtype):
    """On 5,001 columns of the fixture: ``run_nl`` and ``run_tlad`` with
    ``backend="kernels"`` (outputs, tangents, adjoints), the drop-ins in
    both layouts, and ``unblock_outputs`` on streams of the stream
    contract, each against its composition from the sweeps and the
    expressions above."""
    _need_cuda()
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    x = st.device_inputs(RAGGED, dtype=dtype, device="cuda")
    lm = tk.to_levels_major(x)
    got = drivers.run_nl(x, p, backend="kernels")
    want = _before_unblock(kmod.cloudsc2_nl(lm._replace(pqs=None), p), p)
    _same(tuple(got), tuple(v.T for v in want), "run_nl")
    _check_top_rows(Cloudsc2Outputs(*(v.T for v in got)))
    got = drivers.run_tlad(x, p, backend="kernels")
    for name, g, w in zip(("outputs", "tangents", "adjoints"), got, _unit_before(x, p)):
        _same(tuple(g), tuple(v.T for v in w), "run_tlad " + name)
    d = type(lm)(*(0.01 * v for v in lm))
    ws, wd = tk.cloudsc2_tl_din(lm, d, p, lregcl=True)
    fwd, _ = kmod.cloudsc2_fwd_ckpt(lm, p)
    for levels_major in (False, True):
        t = (lambda v: v) if levels_major else (lambda v: v.T)
        a, da = (lm, d) if levels_major else (x, type(d)(*(v.T for v in d)))
        o, do = tk.cloudsc2_kernel_tl(a, da, p, lregcl=True, levels_major=levels_major)
        out, adj = tk.cloudsc2_kernel_ad(a, do, p, lregcl=True, levels_major=levels_major)
        _same(tuple(o), tuple(t(v) for v in _before_unblock(ws, p)), "tl")
        _same(tuple(do), tuple(t(v) for v in _before_unblock(wd, p)), "tl tangents")
        _same(tuple(out), tuple(t(v) for v in _before_unblock(fwd, p)), "ad outputs")
    streams = drivers.run_nl(st.device_kernel_inputs(RAGGED, dtype=dtype, device="cuda"), p)
    _same(tuple(kmod.unblock_outputs(streams, p)),
          tuple(v.T for v in _before_unblock(streams, p)), "unblock_outputs")


# one profiled call of a standard path after a warm one, the card traced
# (one session a process: a second may trace no device operation): the
# device's operations of the call by name, and the contract span's counters
_LAUNCHES = """
import json, sys, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
x = st.device_inputs(16_384, dtype=torch.float32, device="cuda")
call = lambda: getattr(drivers, sys.argv[1])(x, st.params, backend="kernels")
call()
torch.cuda.synchronize()
spans.clear()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
# the device's side of the spans' ranges is no operation of the call
print(json.dumps({"ops": sorted(e.name for e in prof.events()
                                if e.device_type == DeviceType.CUDA
                                and not e.name.startswith(spans.PREFIX)),
                  "contract": spans.summary()["cloudsc2.contract"]}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("entry,ops,seeds", [("run_nl", 3, (False,)),
                                             ("run_tlad", 22, (False, True))])
def test_cuda_launches_of_the_standard_paths(entry, ops, seeds):
    """``run_nl(backend="kernels")`` issues 3 device operations (prelude,
    NL sweep, contract), ``run_tlad`` 22 (16 increments, prelude, TL, two
    contracts, forward-checkpoint, AD); every contract in place, its bytes
    those of the kernel's in-place form."""
    _need_cuda()
    res = subprocess.run([sys.executable, "-c", _LAUNCHES, entry], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(got["ops"]) == ops, got["ops"]
    assert sum("cloudsc2_contract" in k for k in got["ops"]) == len(seeds), got["ops"]
    contract = got["contract"]
    assert contract["count"] == len(seeds)
    assert contract["counters"]["in_place"] == 1
    assert contract["counters"]["bytes"] == sum(
        kmod.contract_bytes(137, 16_384, 4, in_place=True, seeds=s, kernel=True)
        for s in seeds) / len(seeds)
