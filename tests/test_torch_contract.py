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
its forward-checkpoint sweep, with the same results: it runs none, its
reverse sweep reads the checkpoints its TL sweep wrote, and its primal and
tangents are the streamed-increment TL's on PyTorch's increments, its
adjoints within the AD's tolerance of the drop-ins' (at the fixture's 100
columns).  On a card (marked ``cuda``): the kernel against those
expressions on the card, bit for bit, in both forms, both dtypes and a
column count that is neither a multiple of 4 nor of the block; every
standard path against its composition from the sweeps and those
expressions; the unit against the drop-ins at 16,384 columns; the launches
a call issues.

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
# the unit's adjoints against the drop-ins', as a share of each field's
# largest value: the f32 AD kernel's tolerance against its plain version
# (tests/test_torch_cuda.py TLAD_TOL), and the float64 configuration's
# (benchmark/configs/cloudsc2-tlad-f64.json)
ADJOINT_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# and a limit set from the readings: the largest gap read, 7.18e-10 in f32
# and 4.18e-20 in f64 at 16,384 columns on an NVIDIA H100 (the carries of
# the TL and NL bodies differ by ulps), 0 on the plain versions at 100
# columns; the sfl checkpoint scaled by 1 + 1e-6 moves the plain versions'
# adjoints at 100 columns by 1.08e-8 in f32 and 5.85e-9 in f64
ADJOINT_GAP = {torch.float32: 1e-8, torch.float64: 1e-14}
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


@pytest.mark.parametrize("sweep", ["nl", "fwd_ckpt", "tl_din", "tl_std"])
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
        if sweep == "tl_std":
            return tk.cloudsc2_tl_std(x, p, dscale=0.01, out=out)
        return tk.cloudsc2_tl_din(x, d, p, out=out)

    if sweep.startswith("tl_"):
        slots = {**slots, **kmod.flux_slots(d_flux, "d_")}
    got, want = run(slots), run()
    for g, w in zip(got, want):
        _same(g, w, sweep)
    assert got[0].rfln.data_ptr() == flux.pfplsl[1].data_ptr()
    assert got[0].sfln.data_ptr() == flux.pfplsn[1].data_ptr()
    if sweep.startswith("tl_"):
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
    the streamed-increment TL sweep on PyTorch's increments, both contracts
    and the seeds by the expressions above, the forward-checkpoint and
    reverse sweeps, levels-major."""
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


def _unit(x, p):
    """``run_tlad(backend="kernels")`` composed from its sweeps: the
    standard contract's TL sweep (the increments formed in it, the
    checkpoints written), both contracts and the seeds by the expressions
    above, the reverse sweep from the TL's checkpoints, levels-major."""
    lm = tk.to_levels_major(x)
    pre = kmod.kernel_prelude(lm, p)
    out, dout, ckpts = tk.cloudsc2_tl_std(lm, p, dscale=drivers.DSCALE, pre=pre)
    o, do = _before_unblock(out, p), _before_unblock(dout, p)
    seeds = dout._replace(**dict(zip(("rfln", "sfln"), _before_seeds(do, p))))
    adj = tk.cloudsc2_ad(lm, seeds, ckpts, p, fold_seeds=False, pre=pre)
    return o, do, adj


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_tlad_assembles_no_forward_outputs(small, monkeypatch, dtype):
    """The unit assembles two contracts (its TL's primal, and its tangent
    with the seeds), never calls ``unblock_outputs`` and runs no
    forward-checkpoint sweep: its reverse sweep reads the checkpoints of
    its TL sweep, which forms the increments itself.  The triple is that
    composition's; and on the plain versions, whose TL carries are the
    forward sweep's bit for bit, what it was."""
    unblocks = _counting(monkeypatch, "unblock_outputs", (kmod, drivers))
    assembles = _counting(monkeypatch, "assemble_contract", (kmod, tk))
    forward = _counting(monkeypatch, "cloudsc2_fwd_ckpt_reference", (kmod, tk))
    streamed = _counting(monkeypatch, "cloudsc2_tl_din", (tk,))
    x = small.device_inputs(23, dtype=dtype, device="cpu")
    got = drivers.run_tlad(x, small.params, backend="kernels")
    assert unblocks == [] and forward == [] and streamed == []
    assert [(c["flux"] is not None, c.get("seeds", False)) for c in assembles] == [
        (True, False), (True, True)]
    for name, g, w in zip(("outputs", "tangents", "adjoints"), got,
                          _unit(x, small.params)):
        _same(tuple(g), tuple(v.T for v in w), name)
    for name, g, w in zip(("outputs", "tangents", "adjoints"), got,
                          _unit_before(x, small.params)):
        _same(tuple(g), tuple(v.T for v in w), name)


def _against_drop_ins(x, p):
    """``run_tlad(backend="kernels")`` on ``x`` against the drop-ins: its
    primal and tangents are ``cloudsc2_kernel_tl(x, DSCALE·x)``'s (the
    streamed-increment TL on PyTorch's increments) bit for bit, its
    adjoints ``cloudsc2_kernel_ad(x, tangents)``'s (the forward-checkpoint
    sweep's carries) within :data:`ADJOINT_TOL` of each field's largest
    value; prints and returns the largest gap."""
    out, dout, adj = drivers.run_tlad(x, p, backend="kernels")
    d = type(x)(*(drivers.DSCALE * v for v in x))
    o, do = tk.cloudsc2_kernel_tl(x, d, p, lregcl=True)
    _same(tuple(out), tuple(o), "outputs")
    _same(tuple(dout), tuple(do), "tangents")
    _, want = tk.cloudsc2_kernel_ad(x, dout, p, lregcl=True)
    gap = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
              for g, w in zip(adj, want))
    assert all(torch.isfinite(g).all() for g in adj)
    print(f"largest adjoint gap against the drop-ins, {x.pt.dtype}: {gap:.3e}")
    assert gap <= ADJOINT_TOL[x.pt.dtype]
    assert gap <= ADJOINT_GAP[x.pt.dtype]
    return gap


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_tlad_against_the_drop_ins_at_the_fixture(dtype):
    """At the fixture's 100 columns, on the plain versions: the unit's primal
    and tangents are the streamed-increment TL's bit for bit, its adjoints
    within the tolerance of those the forward-checkpoint sweep's carries
    give."""
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    _against_drop_ins(st.device_inputs(100, dtype=dtype, device="cpu"), st.params)


def test_the_halves_assemble_around_the_sweep_and_read_the_checkpoints(small):
    """``tl_contract`` hands the TL sweep it is given the contract's flux
    rows as its ``out``, assembles both contracts there and passes on what
    else the sweep returned (the standard TL's checkpoints; nothing after the
    streamed TL's primal and tangents, the same bits on ``dscale·x``);
    ``ad_from_seeds`` is the reverse sweep from the checkpoints handed to
    it, the seeds taken as folded."""
    p = small.params
    lm = small.device_kernel_inputs(23, dtype=torch.float64, device="cpu", pqs=True)
    given = []

    def sweep(out):
        given.append(out)
        return tk.cloudsc2_tl_std(lm, p, dscale=0.01, out=out)

    out, dout, seeds, ckpts = tk.tl_contract(sweep, lm.pt, p, seeds=True)
    (slots,) = given
    assert set(slots) == {"rfln", "sfln", "d_rfln", "d_sfln"}
    assert slots["rfln"].data_ptr() == out.pfplsl[1].data_ptr()
    assert slots["d_sfln"].data_ptr() == dout.pfplsn[1].data_ptr()
    assert seeds is not None and len(ckpts) == 3
    d = type(lm)(*(0.01 * v for v in lm))
    o, do, none = tk.tl_contract(
        lambda out: tk.cloudsc2_tl_din(lm, d, p, lregcl=True, out=out), lm.pt, p,
        seeds=False)
    assert none is None
    _same(tuple(o) + tuple(do), tuple(out) + tuple(dout), "streamed TL")
    _same(tk.ad_from_seeds(lm, seeds, ckpts, p),
          tk.cloudsc2_ad(lm, seeds, ckpts, p, fold_seeds=False), "adjoints")


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
    expressions above; ``run_tlad``'s outputs and tangents also against its
    composition before, the streamed-increment TL's."""
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
    for name, g, w in zip(("outputs", "tangents", "adjoints"), got, _unit(x, p)):
        _same(tuple(g), tuple(v.T for v in w), "run_tlad " + name)
    for name, g, w in zip(("outputs", "tangents"), got, _unit_before(x, p)):
        _same(tuple(g), tuple(v.T for v in w), "run_tlad before " + name)
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_run_tlad_against_the_drop_ins(dtype):
    """At 16,384 columns of the fixture on the card: ``run_tlad``'s primal
    and tangents are the streamed-increment TL's on PyTorch's increments
    bit for bit (both kernels built without FMA contraction), its adjoints
    within :data:`ADJOINT_TOL` of the drop-in AD's (the forward-checkpoint
    sweep's carries); one launch of the standard contract's TL and of the
    AD, none of the forward-checkpoint or streamed-increment sweeps."""
    _need_cuda()
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    x = st.device_inputs(16_384, dtype=dtype, device="cuda")
    counters = (tk.cloudsc2_tl_std, tk.cloudsc2_ad, kmod.cloudsc2_fwd_ckpt,
                tk.cloudsc2_tl_din)
    before = [f.launches for f in counters]
    drivers.run_tlad(x, st.params, backend="kernels")
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
    _against_drop_ins(x, st.params)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,ops,seeds", [("run_nl", 3, (False,)),
                                             ("run_tlad", 5, (False, True))])
def test_cuda_launches_of_the_standard_paths(entry, ops, seeds):
    """``run_nl(backend="kernels")`` issues 3 device operations (prelude,
    NL sweep, contract), ``run_tlad`` 5 (prelude, TL with the increments
    formed in it, two contracts, AD); every contract in place, its bytes
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
