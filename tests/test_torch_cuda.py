"""CUDA-gated tests of the port: the hand-written kernels on the card.

Marked ``cuda``; each test skips without a CUDA device.  The file imports
neither JAX nor ``conftest``, so on a machine with the card and without
JAX it runs on its own::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import pathlib

import pytest
import torch

from cloudsc2jax_torch import cli
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.state import Cloudsc2State

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


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
                     "--device", "cuda"]) == 0
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
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    counters = (kmod.cloudsc2_fwd_ckpt, tk.cloudsc2_tl_din, tk.cloudsc2_ad)
    before = [f.launches for f in counters]
    assert cli.main([variant, "1", "2048", "128", "--dtype", "f64", "--kernels",
                     "--device", "cuda"]) == 0
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]


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
])
def test_cuda_shipped_f32_kernels_meet_their_register_budget(lib, source, macro,
                                                             entry):
    """ptxas' report of every f32 entry of the shipped TL and AD kernels:
    registers within 64K / (128 threads x the chosen blocks per SM), and no
    more spill than SPILL_LIMIT."""
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    _need_cuda()
    tk._bind(lib)
    blocks = _budget(source, macro)
    limit = 65536 // (128 * blocks)
    entries = [e for e in build.ptxas_report(lib) if entry in e["entry"]]
    assert len(entries) == (8 if lib == "cloudsc2_tl" else 4)
    stores, loads = SPILL_LIMIT[lib]
    for e in entries:
        assert e["registers"] <= limit, e
        assert e["spill_store_bytes"] <= stores and e["spill_load_bytes"] <= loads, e


@pytest.mark.cuda
@pytest.mark.parametrize("lregcl", [False, True])
def test_cuda_tl_parity_without_fma_contraction(lregcl):
    """The TL kernel built with ``-fmad=false`` holds the JAX package's f32
    TL parity, 1e-6 (cloudsc2jax/cli.py:288), against ``jvp`` of the truth
    path on the same f32 inputs; the shipped build keeps contraction and
    ``cli.PALLAS_TL_PARITY_TOL`` (1e-5)."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    i32 = Cloudsc2Inputs(*(x.float() for x in st.device_inputs(
        2048, dtype=torch.float64, device="cuda")))
    d32 = Cloudsc2Inputs(*(DSCALE * x for x in i32))
    with build.variant("cloudsc2_tl_din", flags=("-fmad=false",)):
        launches = tk.cloudsc2_tl_din.launches
        _, dout = tk.cloudsc2_kernel_tl(i32, d32, st.params, lregcl=lregcl)
        assert tk.cloudsc2_tl_din.launches == launches + 1
        assert "-fmad=false" in build._key("cloudsc2_tl_din")[2]
    assert cli.tl_parity(i32, dout, st.params, lregcl=lregcl) < 1e-6
    _, dout = tk.cloudsc2_kernel_tl(i32, d32, st.params, lregcl=lregcl)
    assert cli.tl_parity(i32, dout, st.params, lregcl=lregcl) < cli.PALLAS_TL_PARITY_TOL


# ------------------------------------------- the TL+AD scheduling experiments
@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [100, 5001])
@pytest.mark.parametrize("keep_f32", [("pq", "plu", "paph"),
                                      ("pq", "plu", "paph", "pt", "pmfu")])
def test_cuda_encoded_kernels_match_plain_versions(ncol, keep_f32):
    """The encoded TL (both write_primal settings) and AD kernels against
    their plain versions (chip_smoke.py's phase 12), with the default
    encoding and one that keeps two more streams f32 (the kernels read the
    mask of encoded streams at run time); 5,001 columns start the int16
    rows on odd half-words."""
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex

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
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 1]
    assert none is None
    for got, ref in ((out, r_out), (dout, r_dout), (ck, r_ck), (dout_n, r_dout),
                     (ck_n, r_ck)):
        assert all(torch.isfinite(x).all() for x in got)
        assert _rel_err(got, ref) <= tol_tl
    assert all(torch.isfinite(x).all() for x in adj)
    assert _rel_err(adj, r_adj) <= tol_ad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [100, 5001])
def test_cuda_fused_kernel_matches_plain_version_and_two_kernel_unit(dtype, ncol):
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=True)
    tol_tl, tol_ad = TLAD_TOL[dtype]
    launches = ex.cloudsc2_tlad_fused.launches
    out, dout, adj = ex.cloudsc2_tlad_fused(inputs, st.params)
    assert ex.cloudsc2_tlad_fused.launches == launches + 1
    r_out, r_dout, r_adj = ex.cloudsc2_tlad_fused_reference(inputs, st.params)
    assert all(torch.isfinite(x).all() for x in (*out, *dout, *adj))
    assert _rel_err(out, r_out) <= tol_tl and _rel_err(dout, r_dout) <= tol_tl
    assert _rel_err(adj, r_adj) <= tol_ad
    # the same two level loops in one kernel: the two-kernel unit's results
    # up to the FMA contraction of two builds
    for got, want, tol in zip((out, dout, adj), run_tlad(inputs, st.params),
                              (tol_tl, tol_tl, tol_ad)):
        assert _rel_err(got, want) <= tol
    rel, finite = cli.adjoint_identity(inputs, dout, adj, st.params, DSCALE)
    assert finite and rel < (2e-6 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
def test_cuda_fused_kernel_strides_over_column_batches():
    """More than twice the columns the card holds threads for: each thread
    sweeps several columns through one slot of the checkpoint scratch, the
    last batch ragged."""
    from cloudsc2jax_torch.drivers import run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    ncol = 163_841
    inputs = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                     pqs=True)
    assert ex.fused_slots(inputs, st.params) < ncol / 2
    got = ex.launch_cloudsc2_tlad_fused(
        inputs, kmod.kernel_prelude(inputs, st.params), st.params)
    for g, want, tol in zip(got, run_tlad(inputs, st.params), (1e-5, 1e-5, 1e-4)):
        assert _rel_err(g, want) <= tol


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
    strided = enc._replace(streams=tuple(
        [streams[0].T.contiguous().T] + streams[1:]))
    short = enc._replace(streams=tuple([streams[0][:-1].contiguous()] + streams[1:]))
    for bad in (strided, short, enc._replace(enc=enc.enc[:, :-1].contiguous()),
                enc._replace(ztrpaus=enc.ztrpaus[:-1])):
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
@pytest.mark.parametrize("keep_f32,payload", [
    (("pq", "plu", "paph"), torch.int16),
    (("pq",), torch.int16),
    ((), torch.bfloat16),
    (("pq",), torch.bfloat16),
])
@pytest.mark.parametrize("ncol,ldrain1d", [(100, False), (5001, True)])
def test_cuda_encoded_nl_kernel_matches_plain_version(ncol, ldrain1d, keep_f32,
                                                      payload, fuse_satur):
    """The encoded NL kernel against its plain version on the decoded
    trajectory (chip_smoke.py's phase 15); 5,001 columns start the 16-bit rows
    on odd half-words.  2e-5 against the plain version: the decoded
    trajectories are worse conditioned than the exact one (worst reading
    4.712e-6, where f32 rounding alone moves the plain version 5.0e-6 from
    its f64 self; probes/nl_enc_fmad.py on an NVIDIA H100).  The tight check
    is against the exact kernel on the same decoded inputs."""
    from cloudsc2jax_torch.kernels import experiments as ex

    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                     pqs=True)
    enc = ex.encode_blocked_inputs(inputs, st.params, keep_f32=keep_f32,
                                   fuse_satur=fuse_satur, payload_dtype=payload)
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
        tile = 232_448 // kmod.resident_ring(137, dtype, 1, 137)[2]
    launches = kmod.cloudsc2_nl_resident.launches
    got = kmod.cloudsc2_nl_resident(inputs, st.params, ldrain1d=True, tile=tile,
                                    depth=depth)
    assert kmod.cloudsc2_nl_resident.launches == launches + 1
    ref = kmod.cloudsc2_nl_resident_reference(inputs, st.params, ldrain1d=True)
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
    launches = kmod.cloudsc2_nl_resident.launches
    with pytest.raises(ValueError, match="shared memory"):
        kmod.launch_cloudsc2_nl_resident(inputs, pre, st.params, tile=128, depth=137)
    with pytest.raises(ValueError, match="tile"):
        kmod.launch_cloudsc2_nl_resident(inputs, pre, st.params, tile=512)
    with pytest.raises(ValueError, match="pqs=True"):
        kmod.launch_cloudsc2_nl_resident(inputs._replace(pqs=None), pre, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl_resident(
            inputs._replace(pqs=inputs.pqs.T.contiguous().T), pre, st.params)
    assert kmod.cloudsc2_nl_resident.launches == launches
    enc = ex.encode_blocked_inputs(inputs, st.params, keep_f32=("pq",))
    streams = list(enc.streams)
    for bad in (enc._replace(streams=tuple([streams[0].T.contiguous().T] + streams[1:])),
                enc._replace(streams=tuple([streams[0][:-1].contiguous()] + streams[1:])),
                enc._replace(enc=enc.enc[:, :-1].contiguous()),
                enc._replace(ztrpaus=enc.ztrpaus[:-1]),
                enc._replace(streams=tuple(streams[:-1] + [streams[-1][:-1].contiguous()]))):
        with pytest.raises(ValueError):
            ex.launch_cloudsc2_nl_encoded(bad, st.params)
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
