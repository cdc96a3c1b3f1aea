"""CUDA-gated tests of the port: the hand-written kernels on the card.

Marked ``cuda``; each test skips without a CUDA device.  The file imports
neither JAX nor ``conftest``, so on a machine with the card and without
JAX it runs on its own::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from cloudsc2jax_torch import cli
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.kernels import schedules as sch
from cloudsc2jax_torch.state import Cloudsc2State

import prelude_cases as cases

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ROOT = FIXTURES.parents[1]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_cuda_kernel_matches_plain_version(dtype, tol, ldrain1d):
    """The kernel against its plain version on the same card and inputs
    (the check of chip_smoke.py's phase 3), on a ragged column count."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(1000, dtype=dtype, device="cuda")
    launches = kmod.cloudsc2_nl.launches
    got = kmod.cloudsc2_nl(inputs, st.params, ldrain1d=ldrain1d)
    ref = kmod.cloudsc2_nl_reference(inputs, st.params, ldrain1d=ldrain1d)
    assert kmod.cloudsc2_nl.launches == launches + 1
    for name, a, b in zip(got._fields, got, ref):
        assert torch.isfinite(a).all(), name
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() / scale <= tol, name


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_operands():
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda")
    pre = kmod.kernel_prelude(inputs, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl(inputs._replace(pt=inputs.pt.T.contiguous().T),
                                pre, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl(inputs._replace(pq=inputs.pq.double()),
                                pre, st.params)
    with pytest.raises(TypeError):
        kmod.launch_cloudsc2_nl(
            type(inputs)(*(None if x is None else x.half() for x in inputs)),
            kmod.KernelPrelude(*(x.half() for x in pre)), st.params)


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["nl", "1", "4096", "128", "--dtype", "f32", "--threshold", "10000",
     "--kernels"],
    ["nl", "1", "4096", "128", "--dtype", "f64", "--kernels"],
])
def test_cuda_cli_validates_through_the_kernel(argv):
    _need_cuda()
    launches = kmod.cloudsc2_nl.launches
    assert cli.main(argv + ["--device", "cuda"]) == 0
    assert kmod.cloudsc2_nl.launches == launches + 1


def _rel_err(got, ref):
    return max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(got, ref))


# f32 AD: the plu adjoint carries f32 rounding of ~4e-5 of its maximum in
# the kernel and in the plain version alike (PERF.md)
TLAD_TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-11, 1e-11)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [100, 5000])
def test_cuda_tlad_kernels_match_plain_versions(dtype, ncol):
    """TL (both write_primal settings) and AD kernels against their plain
    versions on the same card and inputs (chip_smoke.py's phase 6)."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=True)
    tol_tl, tol_ad = TLAD_TOL[dtype]
    launches = (tk.cloudsc2_tl.launches, tk.cloudsc2_ad.launches)
    out, dout, ck = tk.cloudsc2_tl(inputs, st.params, dscale=DSCALE)
    none, dout_n, ck_n = tk.cloudsc2_tl(inputs, st.params, dscale=DSCALE,
                                        write_primal=False)
    r_out, r_dout, r_ck = tk.cloudsc2_tl_reference(inputs, st.params, dscale=DSCALE)
    adj = tk.cloudsc2_ad(inputs, r_dout, r_ck, st.params)
    r_adj = tk.cloudsc2_ad_reference(inputs, r_dout, r_ck, st.params)
    assert (tk.cloudsc2_tl.launches, tk.cloudsc2_ad.launches) == (
        launches[0] + 2, launches[1] + 1)
    assert none is None
    for got, ref in ((out, r_out), (dout, r_dout), (ck, r_ck), (dout_n, r_dout),
                     (ck_n, r_ck)):
        assert all(torch.isfinite(x).all() for x in got)
        assert _rel_err(got, ref) <= tol_tl
    assert all(torch.isfinite(x).all() for x in adj)
    assert _rel_err(adj, r_adj) <= tol_ad


@pytest.mark.cuda
def test_cuda_tlad_kernels_reject_bad_operands():
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda", pqs=True)
    pre = kmod.kernel_prelude(inputs, st.params)
    _, dout, ck = tk.launch_cloudsc2_tl(inputs, pre, st.params, dscale=DSCALE)
    bad = inputs._replace(pqs=inputs.pqs.T.contiguous().T)
    with pytest.raises(ValueError):
        tk.launch_cloudsc2_tl(bad, pre, st.params, dscale=DSCALE)
    with pytest.raises(ValueError):
        tk.launch_cloudsc2_ad(bad, pre, dout, ck, st.params)
    with pytest.raises(ValueError):
        tk.launch_cloudsc2_ad(inputs, pre, dout, (ck[0].double(),) + ck[1:], st.params)
    with pytest.raises(ValueError):
        tk.launch_cloudsc2_ad(inputs, pre, dout._replace(rfln=dout.rfln[:-1]), ck,
                              st.params)
    with pytest.raises(ValueError, match="pqs"):
        tk.launch_cloudsc2_tl(inputs._replace(pqs=None), pre, st.params, dscale=DSCALE)
    bad_d = inputs._replace(paph=inputs.paph[:-1].contiguous())
    with pytest.raises(ValueError):
        tk.launch_cloudsc2_tl_din(inputs, bad_d, pre, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_fwd_ckpt(bad, pre, st.params)
    with pytest.raises(ValueError, match="pqs"):
        kmod.launch_cloudsc2_fwd_ckpt(inputs._replace(pqs=None), pre, st.params)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cuda_cli_tlad_through_the_kernels(dtype):
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    launches = (tk.cloudsc2_tl.launches, tk.cloudsc2_ad.launches)
    assert cli.main(["tlad", "1", "4096", "128", "--dtype", dtype,
                     "--kernels", "--device", "cuda"]) == 0
    assert (tk.cloudsc2_tl.launches, tk.cloudsc2_ad.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lregcl", [False, True])
def test_cuda_standalone_kernels_match_plain_versions(dtype, lregcl):
    """The checkpointing forward kernel, the streamed-increment TL kernel
    and the AD kernel with unfolded seeds, at both ``lregcl`` settings,
    against their plain versions on a ragged column count, in f64 with pqs
    moved away from SATUR (chip_smoke.py's phase 9)."""
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(1000, dtype=dtype, device="cuda", pqs=True)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(x):
        return torch.rand(x.shape, generator=gen, device="cuda", dtype=dtype)

    if dtype == torch.float64:
        inputs = inputs._replace(pqs=inputs.pqs * (0.99 + 0.02 * rand(inputs.pqs)))
    d_inputs = type(inputs)(*(0.01 * x * (0.5 + rand(x)) for x in inputs))
    tol_nl = 5e-6 if dtype == torch.float32 else 1e-12
    tol_tl, tol_ad = TLAD_TOL[dtype]
    counters = (kmod.cloudsc2_fwd_ckpt, tk.cloudsc2_tl_din, tk.cloudsc2_ad)
    before = [f.launches for f in counters]
    out, ck = kmod.cloudsc2_fwd_ckpt(inputs, st.params)
    r_out, r_ck = kmod.cloudsc2_fwd_ckpt_reference(inputs, st.params)
    p_out, p_dout = tk.cloudsc2_tl_din(inputs, d_inputs, st.params, lregcl=lregcl)
    rp_out, rp_dout, _ = tk.cloudsc2_tl_reference(inputs, st.params,
                                                  d_inputs=d_inputs, lregcl=lregcl)
    adj = tk.cloudsc2_ad(inputs, rp_dout, r_ck, st.params, lregcl=lregcl,
                         fold_seeds=False)
    r_adj = tk.cloudsc2_ad_reference(inputs, rp_dout, r_ck, st.params,
                                     lregcl=lregcl, fold_seeds=False)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert _rel_err((*out, *ck), (*r_out, *r_ck)) <= tol_nl
    assert _rel_err((*p_out, *p_dout), (*rp_out, *rp_dout)) <= tol_tl
    assert all(torch.isfinite(x).all() for x in adj)
    assert _rel_err(adj, r_adj) <= tol_ad


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tl", "ad"])
def test_cuda_cli_tl_ad_through_the_kernels(variant):
    """``tl``/``ad --kernels`` check the f32 verdicts through
    ``run_tlad(backend="kernels")``: one launch of the standard contract's
    TL and of the AD, none of the forward-checkpoint or streamed-increment
    sweeps."""
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    counters = (kmod.cloudsc2_fwd_ckpt, tk.cloudsc2_tl_din, tk.cloudsc2_tl_std,
                tk.cloudsc2_ad)
    before = [f.launches for f in counters]
    assert cli.main([variant, "1", "2048", "128", "--dtype", "f64", "--kernels",
                     "--device", "cuda"]) == 0
    assert [f.launches - b for f, b in zip(counters, before)] == [0, 0, 1, 1]


# ------------------------------ the rescheduled AD body and register budgets
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_cuda_rescheduled_kernels_match_plain_versions(dtype, lregcl, ldrain1d):
    """The TL kernel (both modes) and the AD kernel as built with their
    register budgets and the rescheduled AD bodies, against
    their plain versions in all four ``Level<EVAP, LREGCL>`` bodies, on a
    ragged grid of 5,001 columns (5,001 = 39 blocks of 128 and 9 columns)."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(5001, dtype=dtype, device="cuda", pqs=True)
    d_inputs = type(inputs)(*(DSCALE * x for x in inputs))
    tol_tl, tol_ad = TLAD_TOL[dtype]
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d)
    out, dout, ck = tk.cloudsc2_tl(inputs, st.params, dscale=DSCALE, **kw)
    r_out, r_dout, r_ck = tk.cloudsc2_tl_reference(inputs, st.params,
                                                   dscale=DSCALE, **kw)
    p_out, p_dout = tk.cloudsc2_tl_din(inputs, d_inputs, st.params, **kw)
    rp_out, rp_dout, _ = tk.cloudsc2_tl_reference(inputs, st.params,
                                                  d_inputs=d_inputs, **kw)
    adj = tk.cloudsc2_ad(inputs, r_dout, r_ck, st.params, **kw)
    r_adj = tk.cloudsc2_ad_reference(inputs, r_dout, r_ck, st.params, **kw)
    for got, ref in ((out, r_out), (dout, r_dout), (ck, r_ck), (p_out, rp_out),
                     (p_dout, rp_dout)):
        assert all(torch.isfinite(x).all() for x in got)
        assert _rel_err(got, ref) <= tol_tl
    assert all(torch.isfinite(x).all() for x in adj)
    assert _rel_err(adj, r_adj) <= tol_ad


@pytest.mark.cuda
def test_cuda_rescheduled_kernels_match_plain_versions_at_the_unit_shape():
    """The TL+AD unit's two kernels against their plain versions at 163,840
    f32 columns, where every SM runs its full budget of blocks."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(163_840, dtype=torch.float32, device="cuda",
                                     pqs=True)
    out, dout, ck = tk.cloudsc2_tl(inputs, st.params, dscale=DSCALE)
    r_out, r_dout, r_ck = tk.cloudsc2_tl_reference(inputs, st.params, dscale=DSCALE)
    adj = tk.cloudsc2_ad(inputs, r_dout, r_ck, st.params)
    r_adj = tk.cloudsc2_ad_reference(inputs, r_dout, r_ck, st.params)
    assert _rel_err((*out, *dout, *ck), (*r_out, *r_dout, *r_ck)) <= 1e-5
    assert _rel_err(adj, r_adj) <= 1e-4


def _budget(source: str, macro: str) -> int:
    import re

    text = (pathlib.Path(kmod.__file__).resolve().parents[1] / "csrc" / source).read_text()
    return int(re.search(rf"#define {macro} (\d+)", text).group(1))


# spill bytes (stores, loads) the budgets chosen by time allow per entry: the
# AD kernel none; the TL kernels at 8 and 7 blocks spilled 12-88 B of stores
# and 16-140 B of loads in the sweep (PERF.md)
SPILL_LIMIT = {"cloudsc2_ad": (0, 0), "cloudsc2_tl": (128, 192),
               "cloudsc2_tl_din": (128, 192)}


@pytest.mark.cuda
@pytest.mark.parametrize("lib,source,macro,entry", [
    ("cloudsc2_ad", "cloudsc2_ad_sweep.cuh", "CLOUDSC2_AD_MIN_BLOCKS_F32",
     "cloudsc2_ad_kernelIf"),
    ("cloudsc2_tl", "cloudsc2_tl_sweep.cuh", "CLOUDSC2_TL_MIN_BLOCKS_F32",
     "cloudsc2_tl_kernelIf"),
    ("cloudsc2_tl_din", "cloudsc2_tl_sweep.cuh", "CLOUDSC2_TL_DIN_MIN_BLOCKS_F32",
     "cloudsc2_tl_din_kernelIf"),
    # the standard contract's TL: the same source built without FMA contraction
    ("cloudsc2_tl -fmad=false", "cloudsc2_tl_sweep.cuh", "CLOUDSC2_TL_MIN_BLOCKS_F32",
     "cloudsc2_tl_kernelIf"),
])
def test_cuda_shipped_f32_kernels_meet_their_register_budget(lib, source, macro,
                                                             entry):
    """ptxas' report of every f32 entry of the shipped TL and AD kernels
    (``lib``: a library's name, then the extra nvcc flags of a build of it):
    registers within 64K / (128 threads x the chosen blocks per SM), and no
    more spill than SPILL_LIMIT."""
    from cloudsc2jax_torch.kernels import build

    _need_cuda()
    name, *flags = lib.split()
    build.load_library(name, (), flags)
    blocks = _budget(source, macro)
    limit = 65536 // (128 * blocks)
    entries = [e for e in build.ptxas_report(name, (), flags) if entry in e["entry"]]
    assert len(entries) == (8 if name == "cloudsc2_tl" else 4)
    stores, loads = SPILL_LIMIT[name]
    for e in entries:
        assert e["registers"] <= limit, e
        assert e["spill_store_bytes"] <= stores and e["spill_load_bytes"] <= loads, e


@pytest.mark.cuda
@pytest.mark.parametrize("lregcl", [False, True])
def test_cuda_tl_parity_without_fma_contraction(lregcl):
    """The TL kernel ships built with ``-fmad=false`` and holds the JAX
    package's f32 TL parity, ``cli.PALLAS_TL_PARITY_TOL`` = 1e-6
    (cloudsc2jax/cli.py:288), against ``jvp`` of the truth path on the same
    f32 inputs."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    _need_cuda()
    assert cli.PALLAS_TL_PARITY_TOL == 1e-6
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    i32 = Cloudsc2Inputs(*(x.float() for x in st.device_inputs(
        2048, dtype=torch.float64, device="cuda")))
    d32 = Cloudsc2Inputs(*(DSCALE * x for x in i32))
    launches = tk.cloudsc2_tl_din.launches
    _, dout = tk.cloudsc2_kernel_tl(i32, d32, st.params, lregcl=lregcl)
    assert tk.cloudsc2_tl_din.launches == launches + 1
    assert "-fmad=false" in build._key("cloudsc2_tl_din")[2]
    assert cli.tl_parity(i32, dout, st.params, lregcl=lregcl) < cli.PALLAS_TL_PARITY_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("lregcl", [False, True])
def test_cuda_tl_std_parity_without_fma_contraction(lregcl):
    """The standard contract's TL+AD unit's TL (increments in registers) is
    ``cloudsc2_tl`` bound from its build with ``build.NO_FMA``, apart from
    the stream contract's contracted build, and holds the JAX package's f32
    TL parity, ``cli.PALLAS_TL_PARITY_TOL`` = 1e-6, on the contract's
    fields; its primal and tangents are the streamed-increment TL's on
    PyTorch's increments bit for bit, and it matches its plain version."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    i32 = Cloudsc2Inputs(*(x.float() for x in st.device_inputs(
        2048, dtype=torch.float64, device="cuda")))
    lm = tk.to_levels_major(i32)
    launches = tk.cloudsc2_tl_std.launches
    out, dout, _, ckpts = tk.tl_contract(
        lambda slots: tk.cloudsc2_tl_std(lm, st.params, dscale=DSCALE, lregcl=lregcl,
                                         out=slots),
        lm.pt, st.params, seeds=False)
    assert tk.cloudsc2_tl_std.launches == launches + 1 and len(ckpts) == 3
    std = build._key(("cloudsc2_tl", (), build.NO_FMA))
    assert std[2] == ("-fmad=false",) and build._LIBRARIES[std] is not tk._library("cloudsc2_tl")
    assert "-fmad=false" not in build._key("cloudsc2_tl")[2]
    dout_t = type(dout)(*(x.T for x in dout))
    assert cli.tl_parity(i32, dout_t, st.params, lregcl=lregcl) < cli.PALLAS_TL_PARITY_TOL
    d = Cloudsc2Inputs(*(DSCALE * x for x in lm))
    s_out, s_dout = tk.cloudsc2_kernel_tl(lm, d, st.params, lregcl=lregcl,
                                          levels_major=True)
    for a, b in zip((*out, *dout), (*s_out, *s_dout)):
        assert torch.equal(a, b)
    r_out, r_dout, r_ck = tk.cloudsc2_tl_reference(lm, st.params, dscale=DSCALE,
                                                   lregcl=lregcl)
    tol_tl, _ = TLAD_TOL[torch.float32]
    got = tk.cloudsc2_tl_std(lm, st.params, dscale=DSCALE, lregcl=lregcl)
    for g, r in zip(got, (r_out, r_dout, r_ck)):
        assert _rel_err(g, r) <= tol_tl


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [100, 16384])
def test_cuda_tl_parity_through_run_tlad(ncol):
    """The gated quantity as the CLI measures it, ``tl_parity`` through
    ``run_tlad(backend="kernels")``, sits under the JAX package's 1e-6 in
    f32, with the adjoint identity inside its budget."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    std = st.device_inputs(ncol, dtype=torch.float32, device="cuda")
    v = cli.measure_f32_verdicts(st, std, lregcl=True)
    assert v["finite"]
    assert v["tl_parity_rel_err"] < v["tl_parity_tol"] == 1e-6
    assert v["ad_identity_rel_err"] < v["ad_identity_tol"]


@pytest.mark.cuda
def test_cuda_bench_tlad_margin_ok():
    """The bench's ``tlad`` f32 record reads ``margin_ok: true``: both f32
    verdicts at least 4x under their tolerances (``bench.py:213``)."""
    _need_cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "cloudsc2jax_torch.bench"],
        env={**os.environ, "CLOUDSC2_BENCH_VARIANT": "tlad",
             "CLOUDSC2_BENCH_REPEATS": "2"},
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    fv = rec["f32_verdicts"]
    assert fv["margin_ok"] is True, fv
    assert fv["tl_parity_tol"] == 1e-6


# ------------------------------------------- the TL+AD scheduling experiments
@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [100, 5001, 163840])
@pytest.mark.parametrize("keep_f32", [("pq", "plu", "paph"),
                                      ("pq", "plu", "paph", "pt", "pmfu")])
def test_cuda_encoded_kernels_match_plain_versions(ncol, keep_f32):
    """The encoded TL (both write_primal settings) and AD kernels against
    their plain versions (chip_smoke.py's phase 12), with the default
    encoding (whose mask has a kernel of its own) and one that keeps two
    more streams f32 (the kernels read that mask at run time); 5,001 columns
    start the int16 rows on odd half-words.  Each equals the exact kernel
    run on the decoded inputs bit for bit, and the pair passes the adjoint
    identity."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                     pqs=True)
    enc = ex.encode_blocked_inputs(inputs, st.params, fuse_satur=False,
                                   keep_f32=keep_f32)
    tol_tl, tol_ad = TLAD_TOL[torch.float32]
    counters = (ex.cloudsc2_tl_encoded, ex.cloudsc2_ad_encoded)
    before = [f.launches for f in counters]
    out, dout, ck = ex.cloudsc2_tl_encoded(enc, st.params, dscale=DSCALE)
    none, dout_n, ck_n = ex.cloudsc2_tl_encoded(enc, st.params, dscale=DSCALE,
                                                write_primal=False)
    r_out, r_dout, r_ck = ex.cloudsc2_tl_encoded_reference(enc, st.params,
                                                           dscale=DSCALE)
    adj = ex.cloudsc2_ad_encoded(enc, r_dout, r_ck, st.params)
    r_adj = ex.cloudsc2_ad_encoded_reference(enc, r_dout, r_ck, st.params)
    pair = ex.cloudsc2_ad_encoded(enc, dout, ck, st.params)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2]
    assert none is None
    for got, ref in ((out, r_out), (dout, r_dout), (ck, r_ck), (dout_n, r_dout),
                     (ck_n, r_ck)):
        assert all(torch.isfinite(x).all() for x in got)
        assert _rel_err(got, ref) <= tol_tl
    assert all(torch.isfinite(x).all() for x in adj)
    assert _rel_err(adj, r_adj) <= tol_ad
    # the exact kernels on the decoded trajectory, under the same flags
    decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, st.params)
    x_out, x_dout, x_ck = tk.launch_cloudsc2_tl(decoded, pre, st.params,
                                                dscale=DSCALE)
    _, x_dout_n, x_ck_n = tk.launch_cloudsc2_tl(decoded, pre, st.params,
                                                dscale=DSCALE, write_primal=False)
    x_adj = tk.launch_cloudsc2_ad(decoded, pre, r_dout, r_ck, st.params)
    assert _equal((*out, *dout, *ck), (*x_out, *x_dout, *x_ck))
    assert _equal((*dout_n, *ck_n), (*x_dout_n, *x_ck_n))
    assert _equal(adj, x_adj)
    rel, finite = cli.adjoint_identity(decoded, dout, pair, st.params, DSCALE)
    assert finite and rel < cli.scaled_identity_tol(cli.PALLAS_AD_IDENTITY_TOL,
                                                    inputs.pt.numel())


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [100, 5001])
@pytest.mark.parametrize("ldrain1d", [False, True])
@pytest.mark.parametrize("lregcl", [False, True])
def test_cuda_fused_kernel_matches_plain_version_and_two_kernel_unit(
        dtype, ncol, ldrain1d, lregcl):
    """Every variant (f32/f64 x evaporation x lregcl) below one tile (100
    columns) and ragged (5,001) against the plain version, and against the
    two-kernel unit: bit for bit in f32 with ldrain1d off, where nvcc
    contracts both builds alike, else up to FMA contraction."""
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=True)
    tol_tl, tol_ad = TLAD_TOL[dtype]
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d)
    launches = ex.cloudsc2_tlad_fused.launches
    out, dout, adj = ex.cloudsc2_tlad_fused(inputs, st.params, **kw)
    assert ex.cloudsc2_tlad_fused.launches == launches + 1
    r_out, r_dout, r_adj = ex.cloudsc2_tlad_fused_reference(inputs, st.params, **kw)
    assert all(torch.isfinite(x).all() for x in (*out, *dout, *adj))
    assert _rel_err(out, r_out) <= tol_tl and _rel_err(dout, r_dout) <= tol_tl
    assert _rel_err(adj, r_adj) <= tol_ad
    unit = run_tlad(inputs, st.params, **kw)
    for got, want, tol in zip((out, dout, adj), unit, (tol_tl, tol_tl, tol_ad)):
        assert _rel_err(got, want) <= tol
        assert ldrain1d or dtype == torch.float64 or _equal(got, want)
    rel, finite = cli.adjoint_identity(inputs, dout, adj, st.params, DSCALE)
    assert finite and rel < (2e-6 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
def test_cuda_fused_kernel_strides_over_column_batches():
    """Many tiles per block (327,680 columns, 2,560 tiles for 396 TL
    warpgroups): the two-kernel unit's results bit for bit; two launches
    bit-identical whichever block took which tile (the dynamic scheduler);
    a launch after a launch of another size (the counter's reset)."""
    from cloudsc2jax_torch.drivers import run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import fused_plan as fp

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    ncol = 327_680
    inputs = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                     pqs=True)
    pre = kmod.kernel_prelude(inputs, st.params)
    plan = ex.fused_launch_plan(inputs, st.params)
    split = fp.PLANS["float32", False, True]
    assert [plan[f] for f in ("tl_groups", "ad_groups", "blocks_per_sm",
                              "tl_registers", "ad_registers", "depth")] == [
        split.tl_groups, split.ad_groups, split.blocks_per_sm,
        split.tl_registers, split.ad_registers, split.depth]
    assert plan["blocks"] * split.tl_groups * 2 < ncol // 128
    assert plan["scratch_bytes"] == split.scratch_bytes(plan["blocks"], 137, "float32")
    first = ex.launch_cloudsc2_tlad_fused(inputs, pre, st.params)
    assert all(_equal(g, w) for g, w in zip(first, run_tlad(inputs, st.params)))
    again = ex.launch_cloudsc2_tlad_fused(inputs, pre, st.params)
    assert all(_equal(g, w) for g, w in zip(again, first))
    small = st.device_kernel_inputs(5001, dtype=torch.float32, device="cuda", pqs=True)
    ex.launch_cloudsc2_tlad_fused(small, kmod.kernel_prelude(small, st.params),
                                  st.params)
    after = ex.launch_cloudsc2_tlad_fused(inputs, pre, st.params)
    assert all(_equal(g, w) for g, w in zip(after, first))


@pytest.mark.cuda
def test_cuda_fused_kernel_roles_keep_their_budgets():
    """The AD and TL roles' registers read from SASS stay within their
    setmaxnreg budgets, and ptxas' count is the launch count the split
    assumes (no role can wait for registers that are not there)."""
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import fused_plan as fp

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(100, dtype=torch.float32, device="cuda", pqs=True)
    plan = ex.fused_launch_plan(inputs, st.params)
    split = fp.PLANS["float32", False, True]
    assert -(-plan["kernel_registers"] // 8) * 8 == split.launch_registers
    roles = build.role_registers("cloudsc2_tlad_fused",
                                 ["cloudsc2_tlad_fused_kernel", "IfLb0ELb1E"])
    assert roles["setmaxreg"] >= 2
    assert roles["tl"]["registers"] <= split.tl_registers
    assert roles["ad"]["registers"] <= split.ad_registers


@pytest.mark.cuda
def test_cuda_experiment_kernels_reject_bad_operands():
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda", pqs=True)
    pre = kmod.kernel_prelude(inputs, st.params)
    enc = ex.encode_blocked_inputs(inputs, st.params, fuse_satur=False)
    _, dout, ck = ex.launch_cloudsc2_tl_encoded(enc, st.params, dscale=DSCALE)
    streams = list(enc.streams)
    # the level-major table 8 B past a 16 B boundary: contiguous, misaligned
    shifted = torch.empty(enc.levels.numel() + 2, device="cuda")[2:].view(
        enc.levels.shape).copy_(enc.levels)
    strided = enc._replace(streams=tuple(
        [streams[0].T.contiguous().T] + streams[1:]))
    short = enc._replace(streams=tuple([streams[0][:-1].contiguous()] + streams[1:]))
    for bad in (strided, short, enc._replace(enc=enc.enc[:, :-1].contiguous()),
                enc._replace(ztrpaus=enc.ztrpaus[:-1]),
                enc._replace(levels=None), enc._replace(levels=enc.levels.cpu()),
                enc._replace(levels=enc.levels[:-1].contiguous()),
                enc._replace(levels=shifted)):
        with pytest.raises(ValueError):
            ex.launch_cloudsc2_tl_encoded(bad, st.params, dscale=DSCALE)
        with pytest.raises(ValueError):
            ex.launch_cloudsc2_ad_encoded(bad, dout, ck, st.params)
    with pytest.raises(ValueError):
        ex.launch_cloudsc2_ad_encoded(enc, dout, (ck[0].double(),) + ck[1:], st.params)
    with pytest.raises(ValueError, match="fuse_satur=False"):
        ex.launch_cloudsc2_tl_encoded(ex.encode_blocked_inputs(inputs, st.params),
                                      st.params, dscale=DSCALE)
    with pytest.raises(ValueError):
        ex.launch_cloudsc2_tlad_fused(
            inputs._replace(pqs=inputs.pqs.T.contiguous().T), pre, st.params)
    with pytest.raises(ValueError, match="pqs"):
        ex.launch_cloudsc2_tlad_fused(inputs._replace(pqs=None), pre, st.params)


@pytest.mark.cuda
def test_cuda_kernel_ab_runs_through_every_kernel(monkeypatch, capsys):
    from cloudsc2jax_torch import kernel_ab
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    monkeypatch.setenv("CLOUDSC2_AB_NGPTOT", "5001")
    monkeypatch.setenv("CLOUDSC2_AB_REPS", "2")
    counters = (tk.cloudsc2_tl, tk.cloudsc2_ad, ex.cloudsc2_tlad_fused,
                ex.cloudsc2_tl_encoded, ex.cloudsc2_ad_encoded)
    before = [f.launches for f in counters]
    summary = kernel_ab.main(["two", "noprim", "fused", "enc", "encnp", "two"])
    # per config: a warm-up over the (up to 4) first variants, then the reps
    assert [f.launches - b for f, b in zip(counters, before)] == [12, 12, 4, 8, 8]
    assert summary["platform"] == "gpu" and summary["device"]
    assert list(summary["configs"]) == ["two", "noprim", "fused", "enc", "encnp",
                                        "two#2"]
    assert "two: " in capsys.readouterr().out


# ------------------------------------------------- the NL-side experiments
@pytest.mark.cuda
@pytest.mark.parametrize("fuse_satur", [True, False])
@pytest.mark.parametrize("keep_f32,payload,kernel", [
    (("pq", "plu", "paph"), torch.int16, "fixed"),
    (("pq", "plu", "paph"), torch.bfloat16, "fixed"),
    (("pq",), torch.int16, "runtime"),
    ((), torch.int16, "runtime"),
    ((), torch.bfloat16, "runtime"),
    (("pq",), torch.bfloat16, "runtime"),
])
@pytest.mark.parametrize("ncol,ldrain1d", [(100, False), (5001, True)])
def test_cuda_encoded_nl_kernel_matches_plain_version(ncol, ldrain1d, keep_f32,
                                                      payload, kernel, fuse_satur):
    """The encoded NL kernel against its plain version on the decoded
    trajectory (chip_smoke.py's phase 15); 5,001 columns start the 16-bit rows
    on odd half-words.  The default encoding runs the kernel of its stream
    order's fixed mask, the others the runtime-mask kernel, plu and paph
    encoded where ``keep_f32`` is empty.  2e-5 against the plain version:
    the decoded trajectories are worse conditioned than the exact one (worst
    reading 4.712e-6, where f32 rounding alone moves the plain version 5.0e-6
    from its f64 self; probes/nl_enc_fmad.py on an NVIDIA H100).  The tight
    check is against the exact kernel on the same decoded inputs: the same
    level body on the same values, bit for bit."""
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                     pqs=True)
    enc = ex.encode_blocked_inputs(inputs, st.params, keep_f32=keep_f32,
                                   fuse_satur=fuse_satur, payload_dtype=payload)
    assert ex.nl_encoded_kernel(enc) == kernel
    launches = ex.cloudsc2_nl_encoded.launches
    got = ex.cloudsc2_nl_encoded(enc, st.params, ldrain1d=ldrain1d)
    ref = ex.cloudsc2_nl_encoded_reference(enc, st.params, ldrain1d=ldrain1d)
    assert ex.cloudsc2_nl_encoded.launches == launches + 1
    assert all(torch.isfinite(x).all() for x in got)
    assert _rel_err(got, ref) <= 2e-5
    decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, st.params)
    twin = (kmod.launch_cloudsc2_nl(decoded, pre, st.params, ldrain1d=ldrain1d)
            if fuse_satur else kmod.launch_cloudsc2_fwd_ckpt(
                decoded, pre, st.params, ldrain1d=ldrain1d)[0])
    assert _rel_err(got, twin) <= 5e-6
    assert all(torch.equal(a, b) for a, b in zip(got, twin))


@pytest.mark.cuda
def test_cuda_all_f32_encoding_gives_the_exact_kernels_results():
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(1000, dtype=torch.float32, device="cuda",
                                     pqs=True)
    enc = ex.encode_blocked_inputs(inputs, st.params, keep_f32=ex.ENCODED_STREAMS)
    got = ex.cloudsc2_nl_encoded(enc, st.params)
    assert _rel_err(got, kmod.cloudsc2_nl(inputs, st.params)) <= 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("tile,depth", [(None, None), (128, 8), (64, 3), ("widest", 137),
                                        (256, 1), (7, 500)])
def test_cuda_resident_kernel_matches_plain_version(dtype, tol, tile, depth):
    """Rings whose depth divides the levels or not, a ragged last block, a
    block of less than a warp, every level resident, and depth past nlev."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(1000, dtype=dtype, device="cuda", pqs=True)
    if tile == "widest":
        tile = 232_448 // ex.resident_ring(137, dtype, 1, 137)[2]
    launches = ex.cloudsc2_nl_resident.launches
    got = ex.cloudsc2_nl_resident(inputs, st.params, ldrain1d=True, tile=tile,
                                    depth=depth)
    assert ex.cloudsc2_nl_resident.launches == launches + 1
    ref = ex.cloudsc2_nl_resident_reference(inputs, st.params, ldrain1d=True)
    fwd, _ = kmod.cloudsc2_fwd_ckpt(inputs, st.params, ldrain1d=True)
    assert all(torch.isfinite(x).all() for x in got)
    assert _rel_err(got, ref) <= tol
    assert _rel_err(got, fwd) <= tol


@pytest.mark.cuda
def test_cuda_nl_experiment_kernels_reject_bad_operands():
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda", pqs=True)
    pre = kmod.kernel_prelude(inputs, st.params)
    launches = ex.cloudsc2_nl_resident.launches
    with pytest.raises(ValueError, match="shared memory"):
        ex.launch_cloudsc2_nl_resident(inputs, pre, st.params, tile=128, depth=137)
    with pytest.raises(ValueError, match="tile"):
        ex.launch_cloudsc2_nl_resident(inputs, pre, st.params, tile=512)
    with pytest.raises(ValueError, match="pqs=True"):
        ex.launch_cloudsc2_nl_resident(inputs._replace(pqs=None), pre, st.params)
    with pytest.raises(ValueError):
        ex.launch_cloudsc2_nl_resident(
            inputs._replace(pqs=inputs.pqs.T.contiguous().T), pre, st.params)
    assert ex.cloudsc2_nl_resident.launches == launches
    enc = ex.encode_blocked_inputs(inputs, st.params, keep_f32=("pq",))
    streams = list(enc.streams)
    for bad in (enc._replace(streams=tuple([streams[0].T.contiguous().T] + streams[1:])),
                enc._replace(streams=tuple([streams[0][:-1].contiguous()] + streams[1:])),
                enc._replace(enc=enc.enc[:, :-1].contiguous()),
                enc._replace(ztrpaus=enc.ztrpaus[:-1]),
                enc._replace(streams=tuple(streams[:-1] + [streams[-1][:-1].contiguous()])),
                enc._replace(levels=None), enc._replace(levels=enc.levels.cpu()),
                enc._replace(levels=enc.levels[:-1].contiguous()),
                enc._replace(levels=enc.levels[:, :15].contiguous()),
                enc._replace(levels=torch.empty(enc.levels.numel() + 2, device="cuda")[
                    2:].view(enc.levels.shape).copy_(enc.levels))):
        with pytest.raises(ValueError):
            ex.launch_cloudsc2_nl_encoded(bad, st.params)
    with pytest.raises(ValueError, match="no encoded NL kernel"):
        ex.launch_cloudsc2_nl_encoded(enc, st.params, kernel="fixed")
    with pytest.raises(TypeError, match="f32 only"):
        ex.launch_cloudsc2_nl_encoded(enc._replace(enc=enc.enc.double()), st.params)


@pytest.mark.cuda
@pytest.mark.parametrize("windows,rev,compute", [
    ("3x2", "0", "0,0"), ("3x2", "1", "2,10"), ("5x2", "1", "0,0"),
    ("2x5", "0", "1,6"),
])
def test_cuda_bw_probe_checks_and_times_its_kernel(monkeypatch, capsys, windows,
                                                   rev, compute):
    """The entry point on the card: the kernel held against the plain version
    forward and reversed (5x2 reads three arrays no output uses), then
    timed; the launch counter shows every launch."""
    from cloudsc2jax_torch import bw_probe

    _need_cuda()
    for key, value in dict(WINDOWS=windows, NLEV="7", NB="3", SUBLANES="2",
                           REPEATS="3", REV=rev, COMPUTE=compute).items():
        monkeypatch.setenv("CLOUDSC2_BW_PROBE_" + key, value)
    launches = bw_probe.window_stream.launches
    rec = bw_probe.main([])
    assert bw_probe.window_stream.launches == launches + 2 + bw_probe.WARMUP + 3
    reads, writes = (int(x) for x in windows.split("x"))
    assert rec["platform"] == "gpu" and rec["device"] and rec["power_limit"]
    assert rec["windows"] == windows and rec["rev"] == (rev == "1")
    assert rec["traffic_bytes"] == (reads + writes) * 7 * 768 * 4
    assert rec["self_check_max_abs_err"] < 1e-6 and rec["ms_per_call"] > 0
    assert '"mode": "windows"' in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_encoding_study_runs_on_the_card(capsys):
    from cloudsc2jax_torch import encoding_study

    _need_cuda()
    table = encoding_study.main([])
    capsys.readouterr()
    assert 1e-4 < table["encodings"]["i16"]["max_field_relerr"] < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tol", [("nl", 5e-6), ("tlad", 1e-4)])
def test_cuda_run_chunked_matches_plain_versions(variant, tol):
    """``run_chunked`` through the kernels against the same call on the
    CPU, which runs the plain versions, relative to the checksum (the
    kernels' tolerances against their plain versions); the kernels launch
    once per chunk."""
    from cloudsc2jax_torch import drivers
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_tl

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    counter = kmod.cloudsc2_nl if variant == "nl" else cloudsc2_tl
    launches = counter.launches
    kw = dict(variant=variant, chunk=256, sublanes=1)
    n, got = drivers.run_chunked(st, 500, device="cuda", **kw)
    assert counter.launches == launches + 2
    m, ref = drivers.run_chunked(st, 500, device="cpu", **kw)
    assert n == m == 512
    assert abs(got - ref) <= tol * abs(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["nl", "tlad"])
def test_cuda_chunk_loop_does_not_synchronise(variant):
    """The chunk loop under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any call that waits for the card; its one read after
    gives what ``run_chunked`` gives, and ``fused_gen`` the same bits as
    regeneration."""
    from cloudsc2jax_torch import drivers

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    kw = dict(variant=variant, chunk=16384)
    n, expected = drivers.run_chunked(st, 40000, **kw)  # uploads the columns
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, acc = drivers.chunk_loop(st, 40000, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (m, float(acc)) == (n, expected) and n == 49152
    period = drivers.chunk_columns(st, 16384, variant=variant, fused_gen=True)
    assert drivers.run_chunked(st, 2 * period, variant=variant, chunk=16384,
                               fused_gen=True) == \
        drivers.run_chunked(st, 2 * period, variant=variant, chunk=period)


@pytest.mark.cuda
def test_cuda_cli_profiles_and_writes_a_golden_file(tmp_path, monkeypatch):
    """``--profile`` on the card traces the kernel by name, and the golden
    file written with ``CLOUDSC2_WRITE_REFERENCE=1`` validates a second run."""
    _need_cuda()
    run = ["nl", "1", "100", "100", "--kernels", "--dtype", "f64", "--device", "cuda"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CLOUDSC2_WRITE_REFERENCE", "1")
    assert cli.main(run + ["--profile", str(tmp_path / "prof")]) == 0
    monkeypatch.delenv("CLOUDSC2_WRITE_REFERENCE")
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    assert "cloudsc2_nl_kernel" in trace.read_text()
    assert cli.main(run + ["--reference", str(tmp_path / cli.WRITTEN_REFERENCE)]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["nl", "chunked"])
def test_cuda_bench_record_names_the_card(monkeypatch, capsys, variant):
    """The bench on the card at a small size: one record with the card's
    name and power limit; the chunked one with the card's memory and the
    peak of allocated memory."""
    from cloudsc2jax_torch import bench

    _need_cuda()
    for k, v in {"CLOUDSC2_BENCH_VARIANT": variant, "CLOUDSC2_BENCH_NGPTOT": "65536",
                 "CLOUDSC2_BENCH_CHUNK": "32768", "CLOUDSC2_BENCH_REPEATS": "2"}.items():
        monkeypatch.setenv(k, v)
    rec = bench.main([])
    capsys.readouterr()
    assert rec["platform"] == "gpu" and rec["device_name"] and rec["power_limit_w"] > 0
    assert rec["value"] > 0
    if variant == "chunked":
        assert 0 < rec["peak_allocated_gb"] < rec["device_memory_gb"]
        assert rec["ngptot"] == 65536 and rec["chunk"] == 32768


# ------------------------------------------------- the column decomposition
def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["nl", "1", "16384", "128", "--dtype", "f32", "--threshold", "10000",
     "--kernels", "--per-device-timing"],
    ["tlad", "1", "16384", "128", "--dtype", "f32", "--kernels"],
])
def test_cuda_cli_two_ranks_on_one_card(argv):
    """Two ranks of the CLI share the card over gloo: both exit 0 and rank
    0 prints the gathered table with both ranks' totals (measured rows for
    ``--per-device-timing``) and the verdict."""
    _need_cuda()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cloudsc2jax_torch", *argv, "--device", "cuda"],
        env={**os.environ, "CLOUDSC2_NUM_PROCESSES": "2",
             "CLOUDSC2_PROCESS_ID": str(rank),
             "CLOUDSC2_COORDINATOR": f"localhost:{port}"},
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    err0 = outs[0][1]
    assert "NUMPROC=2, NUMDEV=1" in err0 and "TOTAL @ rank#1" in err0
    if "--per-device-timing" in argv:
        assert err0.count("(measured)") == 2
        assert "TENDENCY_LOC_T" in err0 and "!!!!" not in err0
    else:
        assert "tlad outputs finite: True" in err0


@pytest.mark.cuda
def test_cuda_dryrun_and_chunked_mesh_without_sync():
    """``dist.dryrun`` on every card, and ``run_chunked(mesh=)``'s chunk
    loop under ``set_sync_debug_mode("error")``, its one reduction after,
    equal to the run without a mesh within 1e-5."""
    from cloudsc2jax_torch import dist
    from cloudsc2jax_torch.drivers import chunk_loop, run_chunked

    _need_cuda()
    worst = dist.dryrun(torch.cuda.device_count())
    assert max(worst.values()) <= 1e-5
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    mesh = dist.column_mesh("cuda")
    kw = dict(variant="nl", chunk=32768, mesh=mesh)
    chunk_loop(st, 32768, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        n, accs = chunk_loop(st, 65536, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    total = float(mesh.reduce(accs, "sum"))
    assert n == 65536
    ref = run_chunked(st, 65536, variant="nl", chunk=32768 * mesh.size)[1]
    assert abs(total - ref) <= 1e-5 * abs(ref)


# --------------------------------- the schedules (chip_smoke.py's phase 21)
CHUNKS = (2, 3, 4)


def _flat(*trees):
    out = []
    for t in trees:
        if t is None:
            continue
        out += [t] if isinstance(t, torch.Tensor) else _flat(*t)
    return out


def _same_or_within(got, want, tol):
    """Bit for bit, or else within ``tol`` of each output's max (a schedule
    that nvcc compiles with other contractions; the distance is printed)."""
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return
    rel = _rel_err(got, want)
    print(f"not bit for bit: max rel err {rel:.3e} (tol {tol:g})")
    assert rel <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [100, 5001])
def test_cuda_xscat_ad_assembles_the_inplace_adjoints(dtype, ncol):
    """The 17-stream AD kernel's streams, assembled in PyTorch, equal the
    in-place AD kernel's adjoints bit for bit, seeds folded and not."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    x = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=True)
    pre = kmod.kernel_prelude(x, st.params)
    _, dout, ck = tk.launch_cloudsc2_tl(x, pre, st.params, dscale=DSCALE)
    for fold in (True, False):
        launches = sch.cloudsc2_ad_xscat.launches
        xscat = sch.cloudsc2_ad_xscat(x, dout, ck, st.params, fold_seeds=fold)
        assert sch.cloudsc2_ad_xscat.launches == launches + 1
        inplace = tk.cloudsc2_ad(x, dout, ck, st.params, fold_seeds=fold)
        assert _equal(xscat, inplace) and len(xscat) == len(inplace)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [100, 5001])
def test_cuda_chunked_kernels_equal_one_level_a_step(dtype, ncol):
    """The chunked TL, streamed-increment TL, forward-checkpoint and
    17-stream AD kernels at C = 2, 3, 4 against their one-level kernels."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    p = st.params
    x = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=True)
    pre = kmod.kernel_prelude(x, p)
    dx = Cloudsc2Inputs(*(DSCALE * v for v in x))
    tol_tl, tol_ad = TLAD_TOL[dtype]
    tol_nl = 5e-6 if dtype == torch.float32 else 1e-12
    tl = tk.launch_cloudsc2_tl(x, pre, p, dscale=DSCALE)
    din = tk.launch_cloudsc2_tl_din(x, dx, pre, p)
    fwd = kmod.launch_cloudsc2_fwd_ckpt(x, pre, p)
    raw = sch.launch_cloudsc2_ad_streams(x, pre, tl[1], tl[2], p)
    for c in CHUNKS:
        _same_or_within(sch.launch_cloudsc2_tl_chunked(x, pre, p, dscale=DSCALE,
                                                       chunk_levels=c), tl, tol_tl)
        _same_or_within(sch.launch_cloudsc2_tl_din_chunked(x, dx, pre, p, chunk_levels=c),
                        din, tol_tl)
        _same_or_within(sch.launch_cloudsc2_fwd_ckpt_chunked(x, pre, p, chunk_levels=c),
                        fwd, tol_nl)
        _same_or_within(sch.launch_cloudsc2_ad_streams(x, pre, tl[1], tl[2], p,
                                                       chunk_levels=c), raw, tol_ad)
    with pytest.raises(ValueError, match="built 2, 3, 4"):
        sch.launch_cloudsc2_tl_chunked(x, pre, p, dscale=DSCALE, chunk_levels=5)


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [100, 5001])
@pytest.mark.parametrize("keep_f32", [("pq", "plu", "paph"),
                                      ("pq", "plu", "paph", "pt", "pmfu")])
def test_cuda_bf16_encoded_kernels_equal_the_exact_kernels(ncol, keep_f32):
    """The encoded TL and AD kernels on a bfloat16 encoding equal the exact
    kernels on the decoded inputs bit for bit, both write_primal settings."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    p = st.params
    x = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
    enc = ex.encode_blocked_inputs(x, p, fuse_satur=False, keep_f32=keep_f32,
                                   payload_dtype=torch.bfloat16)
    launches = (ex.cloudsc2_tl_encoded.launches_bf16, ex.cloudsc2_ad_encoded.launches_bf16)
    tl = ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE)
    tln = ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE, write_primal=False)
    adj = ex.cloudsc2_ad_encoded(enc, tl[1], tl[2], p)
    assert (ex.cloudsc2_tl_encoded.launches_bf16,
            ex.cloudsc2_ad_encoded.launches_bf16) == (launches[0] + 2, launches[1] + 1)
    decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, p)
    assert _equal(_flat(tl), _flat(tk.launch_cloudsc2_tl(decoded, pre, p, dscale=DSCALE)))
    assert tln[0] is None and _equal(_flat(tln), _flat(tk.launch_cloudsc2_tl(
        decoded, pre, p, dscale=DSCALE, write_primal=False)))
    assert _equal(adj, tk.launch_cloudsc2_ad(decoded, pre, tl[1], tl[2], p))


def _kernel_launches(x, params):
    """Every kernel library of the port, one launch each on the inputs ``x``
    (f32, with pqs), by name: a function returning the launch's outputs."""
    from cloudsc2jax_torch import bw_probe
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    p = params
    pre = kmod.kernel_prelude(x, p)
    dx = Cloudsc2Inputs(*(DSCALE * v for v in x))
    _, dout, ck = tk.launch_cloudsc2_tl(x, pre, p, dscale=DSCALE)
    enc = {t: ex.encode_blocked_inputs(x, p, fuse_satur=False, payload_dtype=t)
           for t in (torch.int16, torch.bfloat16)}
    runs = {
        "prelude": lambda: kmod.kernel_prelude(x, p),
        "contract": lambda: kmod.assemble_contract(dout, p, seeds=True),
        "nl": lambda: kmod.launch_cloudsc2_nl(x, pre, p),
        "fwd_ckpt": lambda: kmod.launch_cloudsc2_fwd_ckpt(x, pre, p),
        "nl_res": lambda: ex.launch_cloudsc2_nl_resident(x, pre, p),
        "nl_enc": lambda: ex.launch_cloudsc2_nl_encoded(ex.encode_blocked_inputs(x, p), p),
        "tl": lambda: tk.launch_cloudsc2_tl(x, pre, p, dscale=DSCALE),
        "tl_din": lambda: tk.launch_cloudsc2_tl_din(x, dx, pre, p),
        "tl_std": lambda: tk.launch_cloudsc2_tl_std(x, pre, p, dscale=DSCALE),
        "ad": lambda: tk.launch_cloudsc2_ad(x, pre, dout, ck, p),
        "tlad_fused": lambda: ex.launch_cloudsc2_tlad_fused(x, pre, p),
        "tl_enc": lambda: ex.launch_cloudsc2_tl_encoded(enc[torch.int16], p, dscale=DSCALE),
        "ad_enc": lambda: ex.launch_cloudsc2_ad_encoded(enc[torch.int16], dout, ck, p),
        "bw_probe": lambda: bw_probe.launch_window_stream([x.pt + j for j in range(15)],
                                                          2.0, 8),
        "ad_xscat": lambda: sch.launch_cloudsc2_ad_streams(x, pre, dout, ck, p),
        "tl_enc_bf16": lambda: ex.launch_cloudsc2_tl_encoded(enc[torch.bfloat16], p,
                                                             dscale=DSCALE),
        "ad_enc_bf16": lambda: ex.launch_cloudsc2_ad_encoded(enc[torch.bfloat16], dout,
                                                             ck, p),
        "tl_chunk": lambda: sch.launch_cloudsc2_tl_chunked(x, pre, p, dscale=DSCALE,
                                                           chunk_levels=2),
        "tl_din_chunk": lambda: sch.launch_cloudsc2_tl_din_chunked(x, dx, pre, p,
                                                                   chunk_levels=3),
        "fwd_chunk": lambda: sch.launch_cloudsc2_fwd_ckpt_chunked(x, pre, p,
                                                                  chunk_levels=4),
        "ad_chunk": lambda: sch.launch_cloudsc2_ad_streams(x, pre, dout, ck, p,
                                                           chunk_levels=2),
    }
    return runs


KERNEL_LIBRARIES = ("prelude", "contract", "nl", "fwd_ckpt", "nl_res", "nl_enc", "tl", "tl_din",
                    "tl_std", "ad",
                    "tlad_fused", "tl_enc", "ad_enc", "bw_probe", "ad_xscat",
                    "tl_enc_bf16", "ad_enc_bf16", "tl_chunk", "tl_din_chunk",
                    "fwd_chunk", "ad_chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_LIBRARIES)
def test_cuda_kernels_are_deterministic(name):
    """Two launches of each kernel library on the same inputs give the same
    bits (a ragged 5,001 f32 columns; the plain versions' half of this runs
    on the CPU in test_torch_schedules.py)."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    x = st.device_kernel_inputs(5001, dtype=torch.float32, device="cuda", pqs=True)
    run = _kernel_launches(x, st.params)[name]
    first, second = _flat(run()), _flat(run())
    torch.cuda.synchronize()
    assert first and all(torch.equal(a, b) for a, b in zip(first, second))


def _prelude_inputs(pt, ten_t):
    nlev, ncol = pt.shape
    none = kmod.Cloudsc2Inputs(*(None for _ in kmod.Cloudsc2Inputs._fields))
    return none._replace(pt=pt, ten_t=ten_t, paph=pt.new_zeros(nlev + 1, ncol))


def _check_prelude(x, p):
    launches = kmod.kernel_prelude.launches
    got = kmod.kernel_prelude(x, p)
    assert kmod.kernel_prelude.launches == launches + 1
    want = kmod.plain_prelude(x, p)
    torch.cuda.synchronize()
    assert torch.equal(got.ztrpaus, want.ztrpaus)
    assert got.paph_sfc.data_ptr() == x.paph[x.pt.shape[0]].data_ptr()
    return got.ztrpaus


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(cases.CETA))
def test_cuda_prelude_kernel_is_the_plain_expression(name, dtype):
    """The prelude's kernel against the plain expression on the card, bit for
    bit, over every eta profile of the CPU tests (a band from level 0, to
    the bottom, empty, non-monotone, edges that rounding moves), with
    inversions forced at the hull's first and last level and at nlev-2, on
    5,001 columns (not a multiple of the block); and against the CPU's
    answer on the same inputs, which ``test_torch_prelude.py`` holds to
    the JAX package's ``_tropopause_eta_lm`` (JAX does not run here)."""
    _need_cuda()
    p = cases.params(name)
    pt, ten_t = cases.columns(p, cases.NCOL, dtype)
    cpu = kmod.kernel_prelude(_prelude_inputs(pt, ten_t), p).ztrpaus
    ztrpaus = _check_prelude(_prelude_inputs(pt.cuda(), ten_t.cuda()), p)
    assert torch.equal(ztrpaus, cpu.cuda())
    k_lo, k_hi = kmod.tropopause_hull(p, dtype)
    assert (ztrpaus != 0.1).any() == (k_lo <= k_hi)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["dwarf", "benchmark_seed1", "benchmark_seed7"])
def test_cuda_prelude_kernel_on_the_dwarfs_columns(name, dtype):
    """The dwarf's stored columns tiled to 4,099 columns on the card, under
    its own eta profile and the benchmark's; a column slice of them (rows
    wider than the slice) and a transposed copy (no unit column stride) go
    to the kernel too and give the same bits."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    p = cases.params(name)
    x = st.device_kernel_inputs(4099, dtype=dtype, device="cuda")
    _check_prelude(x, p)
    cut = kmod.Cloudsc2Inputs(*(None if v is None else v[:, 5:4001] for v in x))
    assert cut.pt.stride() == (4099, 1)
    _check_prelude(cut, p)
    moved = kmod.Cloudsc2Inputs(*(None if v is None else v.T.contiguous().T
                                  for v in x))
    assert moved.pt.stride() == (1, 137)
    _check_prelude(moved, p)


@pytest.mark.cuda
def test_cuda_streams_units_are_bit_for_bit_with_the_plain_prelude():
    """run_nl and run_tlad on the stream contract give the bits of their
    sweeps handed the plain expression's prelude."""
    _need_cuda()
    from cloudsc2jax_torch.drivers import DSCALE, run_nl, run_tlad
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    st = Cloudsc2State.load(FIXTURES / "input.npz")
    p = st.params
    x = st.device_kernel_inputs(5001, dtype=torch.float32, device="cuda")
    pre = kmod.plain_prelude(x, p)
    got, want = run_nl(x, p), kmod.launch_cloudsc2_nl(x, pre, p)
    xq = st.device_kernel_inputs(5001, dtype=torch.float32, device="cuda", pqs=True)
    pre = kmod.plain_prelude(xq, p)
    unit = run_tlad(xq, p, backend="streams")
    out, dout, ck = tk.cloudsc2_tl(xq, p, dscale=DSCALE, lregcl=True, pre=pre)
    adj = tk.cloudsc2_ad(xq, dout, ck, p, lregcl=True, pre=pre)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    flat, ref = _flat(unit), _flat((out, dout, adj))
    assert len(flat) == len(ref) and all(torch.equal(a, b) for a, b in zip(flat, ref))


@pytest.mark.cuda
def test_cuda_prelude_counts_one_launch_a_call():
    """Each entry computes one prelude a call, and on the card that is one
    launch of the prelude's kernel."""
    _need_cuda()
    from cloudsc2jax_torch.drivers import run_nl, run_tlad

    st = Cloudsc2State.load(FIXTURES / "input.npz")
    x = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda", pqs=True)
    views = st.device_inputs(300, dtype=torch.float32, device="cuda")
    for call in (lambda: run_nl(x, st.params),
                 lambda: run_nl(views, st.params, backend="kernels"),
                 lambda: run_tlad(x, st.params),
                 lambda: run_tlad(views, st.params, backend="kernels")):
        launches = kmod.kernel_prelude.launches
        call()
        assert kmod.kernel_prelude.launches == launches + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_prelude_kernel_rejects_a_ceta_of_another_length():
    """The kernel reads the hull's rows of pt: an eta profile with more levels
    than pt raises before the launch, as the plain expression's broadcast
    raises; so do CUDA inputs of another dtype, which the kernel does not
    take."""
    _need_cuda()
    p = cases.params("dwarf")
    pt, ten_t = cases.columns(p, 300, torch.float32, "cuda")
    launches = kmod.kernel_prelude.launches
    with pytest.raises(ValueError):
        kmod.kernel_prelude(_prelude_inputs(pt[:90], ten_t[:90]), p)
    with pytest.raises(TypeError):
        kmod.kernel_prelude(_prelude_inputs(pt.bfloat16(), ten_t.bfloat16()), p)
    with pytest.raises(RuntimeError):
        kmod.tropopause_eta_lm(pt[:90] + p.ptsphy * ten_t[:90],
                               kmod.level_scalars(p, pt)[0])
    assert kmod.kernel_prelude.launches == launches
