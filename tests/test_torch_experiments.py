"""The port's TL+AD scheduling experiments against the JAX package: the
int16 stream encoder, the encoded TL and AD sweeps, the fused TL+AD unit and
the ``kernel_ab`` harness.

Inputs are the JAX package's synthetic state (nlev 23, 256 columns, f32,
one sublane), fed to both packages; the Pallas kernels run in interpret
mode exactly as ``tests/test_pallas_tlad.py:217-283,364-394`` run them, once
per module.  On the CPU the port's wrappers run the kernels' plain versions.
Tolerances are max |port - jax| / max |jax| per field unless stated:

* encoder: payloads equal as int16, table within 1 f32 ulp, the per-column
  operands equal;
* encoded TL (tangents, checkpoints, primal) 1e-5, encoded AD on the
  Pallas TL's own tangents and checkpoints 1e-4, as for the exact sweeps
  in ``test_torch_tlad.py``; both sides decode the same bits
  (``convert.encoded_from_numpy``);
* fused unit: out and dout 1e-5, adjoints 1e-4 (the JAX test's own budget
  for fused against two-kernel, ``test_pallas_tlad.py:387-394``);
* the JAX tests' physics checks on the port: encoded against exact unit in
  L1-relative 2e-3 / 5e-3 / 5e-3 (primal / tangent / adjoint), the adjoint
  identity through the encoded pair below 1e-5, and in f64 through the
  fused unit below 1e-10.
"""

import json

import numpy as np
import pytest
import torch

from cloudsc2jax.drivers import DSCALE as JDSCALE
from cloudsc2jax.pallas import experiments as jex
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import cli, kernel_ab
from cloudsc2jax_torch.convert import (
    encoded_from_numpy,
    inputs_from_numpy,
    params_from_jax,
)
from cloudsc2jax_torch.drivers import DSCALE, run_tlad
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.kernels.cloudsc2_kernel import Cloudsc2StreamOutputs
from cloudsc2jax_torch.state import Cloudsc2State


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _lm(x):
    """Blocked ``(nlev, nb, S, 128)`` -> levels-major ``(nlev, ncol)``."""
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1)


def _port_encoding(jenc):
    return encoded_from_numpy(jenc.streams, jenc.enc, jenc.ztrpaus, jenc.paphsfc)


@pytest.fixture(scope="module")
def jax_unit():
    """The JAX side, once: blocked inputs, their encoding, the encoded
    Pallas TL (both write_primal settings) and AD, and the fused Pallas
    unit, all in interpret mode; and the same inputs for the port."""
    st = JaxState.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    jenc = jex.encode_blocked_inputs(blk, st.params, fuse_satur=False)
    tl = {wp: jex.cloudsc2_pallas_tl_encoded(
        jenc, st.params, dscale=JDSCALE, lregcl=True, write_primal=wp,
        interpret=True) for wp in (True, False)}
    _, dout, ck = tl[True]
    _, adj = jex.cloudsc2_pallas_ad_encoded(
        jenc, dout, st.params, checkpoints=ck, lregcl=True, fold_seeds=True,
        interpret=True)
    fused = jex.cloudsc2_pallas_tlad_fused(blk, st.params, lregcl=True,
                                           interpret=True)
    tin = inputs_from_numpy(type(blk)(*(_lm(x).T for x in blk)),
                            dtype=torch.float32)
    return dict(state=st, blk=blk, jenc=jenc, tl=tl, adj=adj, fused=fused,
                tin=tin, params=params_from_jax(st.params))


@pytest.fixture(scope="module")
def port_unit(jax_unit):
    """The port's plain encoded unit and plain exact unit on those inputs."""
    p, tin = jax_unit["params"], jax_unit["tin"]
    enc = ex.encode_blocked_inputs(tin, p, fuse_satur=False)
    out, dout, ck = ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE)
    adj = ex.cloudsc2_ad_encoded(enc, dout, ck, p)
    return dict(enc=enc, encoded=(out, dout, adj), exact=run_tlad(tin, p))


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("fuse_satur,keep_f32", [
    (True, ("pq", "plu", "paph")),
    (False, ("pq", "plu", "paph")),
    (False, ("pq", "plu", "paph", "pt", "psupsat")),
])
def test_encoder_matches_jax(jax_unit, fuse_satur, keep_f32):
    """Same payload bits, same table, same per-column operands.  A payload
    may differ by one step where the two packages' f32 division rounds to
    opposite sides of a half: none does on these inputs."""
    st, blk = jax_unit["state"], jax_unit["blk"]
    want = _port_encoding(jex.encode_blocked_inputs(
        blk, st.params, fuse_satur=fuse_satur, keep_f32=keep_f32))
    got = ex.encode_blocked_inputs(jax_unit["tin"], jax_unit["params"],
                                   fuse_satur=fuse_satur, keep_f32=keep_f32)
    assert got.fuse_satur == want.fuse_satur == fuse_satur
    assert len(got.streams) == (15 if fuse_satur else 16)
    assert ("pqs" in got.names) == (not fuse_satur)
    off_by_one = 0
    for name, a, b in zip(got.names, got.streams, want.streams):
        assert a.dtype == b.dtype == (torch.float32 if name in keep_f32
                                      else torch.int16), name
        assert a.shape == b.shape, name
        d = (a.int() - b.int()).abs() if a.dtype == torch.int16 else (a - b).abs()
        assert d.max() <= (1 if a.dtype == torch.int16 else 0), name
        off_by_one += int((d != 0).sum())
    assert off_by_one == 0
    assert got.enc.shape == want.enc.shape == (len(got.streams), 24, 2)
    ulp = np.spacing(np.abs(want.enc.numpy()))
    assert (np.abs(got.enc.numpy() - want.enc.numpy()) <= ulp).all()
    assert torch.equal(got.ztrpaus, want.ztrpaus)
    assert torch.equal(got.paphsfc, want.paphsfc)


def test_round_trip_within_half_a_step(port_unit, jax_unit):
    enc, tin = port_unit["enc"], jax_unit["tin"]
    dec = ex.decode_inputs(enc)
    for i, name in enumerate(enc.names):
        x, y = getattr(tin, name), getattr(dec, name)
        if enc.streams[i].dtype == torch.float32:
            assert torch.equal(x, y), name
            assert torch.equal(enc.enc[i], torch.tensor([1.0, 0.0]).expand(24, 2))
            continue
        scale = enc.enc[i, : x.shape[0], 0:1]
        # half a step, plus the rounding of the divide, the decode's product
        # and its sum: a few ulp of the level's largest value
        slack = 4 * torch.finfo(torch.float32).eps * x.abs().amax(dim=1, keepdim=True)
        assert ((x - y).abs() <= 0.5 * scale + slack).all(), name


def test_constant_level_decodes_to_itself(jax_unit):
    tin, p = jax_unit["tin"], jax_unit["params"]
    flat = tin._replace(pt=tin.pt.clone(), ten_l=torch.zeros_like(tin.ten_l))
    flat.pt[5] = 231.25
    enc = ex.encode_blocked_inputs(flat, p, fuse_satur=False)
    i = enc.names.index("pt")
    assert enc.enc[i, 5, 0] == np.float32(1e-30) and enc.enc[i, 5, 1] == 231.25
    assert (enc.streams[i][5] == 0).all()
    dec = ex.decode_inputs(enc)
    assert torch.equal(dec.pt[5], flat.pt[5])
    assert torch.equal(dec.ten_l, flat.ten_l)


# ---------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("write_primal", [True, False])
def test_plain_tl_encoded_matches_pallas_interpret(jax_unit, write_primal):
    jout, jdout, jck = jax_unit["tl"][write_primal]
    out, dout, ck = ex.cloudsc2_tl_encoded(
        _port_encoding(jax_unit["jenc"]), jax_unit["params"], dscale=DSCALE,
        write_primal=write_primal)
    assert (out is None) == (jout is None) == (not write_primal)
    pairs = list(zip(dout, jdout)) + list(zip(ck, jck))
    if write_primal:
        pairs += list(zip(out, jout))
    for a, b in pairs:
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), _lm(b)) < 1e-5


def test_plain_ad_encoded_matches_pallas_interpret(jax_unit):
    """The plain encoded AD fed the Pallas TL's own tangents and
    checkpoints, so both reverse sweeps start from identical seeds."""
    _, jdout, jck = jax_unit["tl"][True]
    seeds = Cloudsc2StreamOutputs(*(torch.from_numpy(_lm(x)) for x in jdout))
    ckpts = tuple(torch.from_numpy(_lm(x)) for x in jck)
    adj = ex.cloudsc2_ad_encoded(_port_encoding(jax_unit["jenc"]), seeds, ckpts,
                                 jax_unit["params"])
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), _lm(getattr(jax_unit["adj"], n))) < 1e-4, n


def test_plain_fused_matches_pallas_interpret(jax_unit):
    jout, jdout, jadj = jax_unit["fused"]
    out, dout, adj = ex.cloudsc2_tlad_fused(jax_unit["tin"], jax_unit["params"])
    for a, b in list(zip(out, jout)) + list(zip(dout, jdout)):
        assert _rel(a.numpy(), _lm(b)) < 1e-5
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), _lm(getattr(jadj, n))) < 1e-4, n


# ------------------------------------------- the JAX tests' physics checks
def test_encoded_unit_tracks_the_exact_unit(port_unit):
    """Within the quantisation budget of ``test_pallas_tlad.py:258-266``."""
    for what, got, want, tol in zip(("primal", "tangent", "adjoint"),
                                    port_unit["encoded"], port_unit["exact"],
                                    (2e-3, 5e-3, 5e-3)):
        for name, a, b in zip(want._fields, got, want):
            a, b = a.double(), b.double()
            assert (a - b).abs().sum() / b.abs().sum().clamp_min(1e-30) < tol, (what, name)


def test_adjoint_identity_through_the_encoded_pair(port_unit, jax_unit):
    """TL and AD are derivatives of one quantised primal, so with dx =
    DSCALE * decoded(x) the identity holds to f32 rounding, not to the
    quantisation error (``test_pallas_tlad.py:268-283``)."""
    _, dout, adj = port_unit["encoded"]
    rel, finite = cli.adjoint_identity(ex.decode_inputs(port_unit["enc"]), dout,
                                       adj, jax_unit["params"], DSCALE)
    assert finite and rel < 1e-5


def test_fused_f64_passes_the_identity_and_equals_the_two_sweep_unit():
    st = Cloudsc2State.synthetic(ngptot=16, nlev=23)
    inputs = st.device_kernel_inputs(16, dtype=torch.float64, device="cpu", pqs=True)
    out, dout, adj = ex.cloudsc2_tlad_fused(inputs, st.params)
    rel, finite = cli.adjoint_identity(inputs, dout, adj, st.params, DSCALE)
    assert finite and rel < 1e-10
    for got, want in zip((out, dout, adj), run_tlad(inputs, st.params)):
        for n, a, b in zip(want._fields, got, want):
            assert a.dtype == torch.float64 and torch.equal(a, b), n


# ----------------------------------------------------------- contract errors
def test_encoded_sweeps_refuse_what_they_do_not_take(port_unit, jax_unit):
    p, tin, enc = jax_unit["params"], jax_unit["tin"], port_unit["enc"]
    _, dout, _ = port_unit["encoded"]
    ck = tuple(dout[:3])
    fused_satur = ex.encode_blocked_inputs(tin, p)  # 15 streams, pqs dropped
    with pytest.raises(ValueError, match="fuse_satur=False"):
        ex.cloudsc2_tl_encoded(fused_satur, p, dscale=DSCALE)
    with pytest.raises(ValueError, match="fuse_satur=False"):
        ex.cloudsc2_ad_encoded(fused_satur, dout, ck, p)
    for name in ("pq", "plu", "paph"):
        keep = tuple(n for n in ("pq", "plu", "paph") if n != name)
        bad = ex.encode_blocked_inputs(tin, p, fuse_satur=False, keep_f32=keep)
        with pytest.raises(ValueError, match=f"keeps {name} f32"):
            ex.cloudsc2_tl_encoded(bad, p, dscale=DSCALE)
        with pytest.raises(ValueError, match=f"keeps {name} f32"):
            ex.cloudsc2_ad_encoded(bad, dout, ck, p)
    f64 = enc._replace(streams=tuple(
        s.double() if s.dtype == torch.float32 else s for s in enc.streams))
    with pytest.raises(TypeError, match="f32 only"):
        ex.cloudsc2_tl_encoded(f64, p, dscale=DSCALE)
    with pytest.raises(TypeError, match="f32 only"):
        ex.cloudsc2_ad_encoded(enc._replace(enc=enc.enc.double()), dout, ck, p)
    with pytest.raises(ValueError, match="pqs"):
        ex.encode_blocked_inputs(tin._replace(pqs=None), p, fuse_satur=False)
    with pytest.raises(ValueError, match="pqs"):
        ex.cloudsc2_tlad_fused(tin._replace(pqs=None), p)


def test_wrappers_take_cpu_or_cuda_only(port_unit, jax_unit):
    p, tin, enc = jax_unit["params"], jax_unit["tin"], port_unit["enc"]
    _, dout, _ = port_unit["encoded"]
    meta = enc._replace(paphsfc=enc.paphsfc.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ex.cloudsc2_tl_encoded(meta, p, dscale=DSCALE)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ex.cloudsc2_ad_encoded(meta, dout, tuple(dout[:3]), p)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ex.cloudsc2_tlad_fused(type(tin)(*(x.to("meta") for x in tin)), p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ex.launch_cloudsc2_tl_encoded(enc, p, dscale=DSCALE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ex.launch_cloudsc2_ad_encoded(enc, dout, tuple(dout[:3]), p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ex.launch_cloudsc2_tlad_fused(tin, ex.kernel_prelude(tin, p), p)


# ---------------------------------------------------------------- kernel_ab
def test_kernel_ab_runs_every_config_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CLOUDSC2_AB_NGPTOT", "100")
    monkeypatch.setenv("CLOUDSC2_AB_REPS", "1")
    configs = ["two", "noprim", "fused", "enc", "encnp", "two"]
    summary = kernel_ab.main(configs + ["--nlev", "11"],
                             device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[:-1]] == configs
    assert json.loads(lines[-1]) == summary
    assert summary["platform"] == "cpu" and summary["ngptot"] == 100
    assert summary["reps"] == 1 and summary["nlev"] == 11
    assert list(summary["configs"]) == ["two", "noprim", "fused", "enc", "encnp",
                                        "two#2"]
    for rec in summary["configs"].values():
        assert rec["ms"] > 0 and rec["mcols_per_s"] > 0


@pytest.mark.parametrize("cfg,message", [
    ("chunk:64:2", "chunk_levels"),
    ("xscat:64", "17-stream"),
    ("two:64", "sublanes"),
    ("resident", "unknown config"),
])
def test_kernel_ab_refuses_what_has_no_meaning_here(cfg, message):
    with pytest.raises(ValueError, match=message):
        kernel_ab.main(["two", cfg], device="cpu")
