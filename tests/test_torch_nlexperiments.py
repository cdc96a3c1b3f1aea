"""The port's NL-side experiments against the JAX package: the encoded NL
sweep (int16 and bfloat16 payloads), the resident NL sweep, the
window-matched bandwidth probe and the storage-encoding study.

Inputs are the JAX package's synthetic state (nlev 17, 1,024 columns, f32,
two sublanes, as ``tests/test_pallas.py:139-140`` uses), fed to both
packages; the Pallas kernels run in interpret mode, once per module.  On the
CPU the port's wrappers run the kernels' plain versions.  Tolerances are max
|port - jax| / max |jax| per field unless stated:

* plain encoded NL against ``cloudsc2_pallas_encoded(interpret=True)`` on
  the JAX encoding carried across bit for bit
  (``convert.encoded_from_numpy``): 5e-6, the NL kernel's own budget;
* encoder with ``payload_dtype=bfloat16``: payload bits (up to the sign of
  a zero), table and per-column operands equal to JAX's;
* plain resident against ``cloudsc2_pallas(mode="resident",
  interpret=True, sublanes=2)``: 5e-6; identical to the forward-checkpoint
  plain sweep's outputs;
* probe: the plain version equals a numpy rendering of
  ``tools/bw_probe.py:78-94`` to f32 rounding, and the record's shape fields
  equal ``tools.bw_probe.window_probe()``'s in interpret mode;
* ``encoding_study.quantize`` equals ``tools.encoding_study.quantize`` bit
  for bit, and the study's i16 row lies in DESIGN.md section 8's band.
"""

import dataclasses
import importlib
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from cloudsc2jax.pallas import experiments as jex
from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import bw_probe, encoding_study
from cloudsc2jax_torch.convert import (
    encoded_from_numpy,
    inputs_from_numpy,
    params_from_jax,
)
from cloudsc2jax_torch.drivers import DSCALE
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import experiments as ex

NCOL, NLEV = 1024, 17
KEEPS = {"default": ("pq", "plu", "paph"), "pq": ("pq",), "none": (),
         "all": ex.ENCODED_STREAMS}
CSRC = pathlib.Path(kmod.__file__).parents[1] / "csrc"


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
def jax_side():
    """The JAX side, once: blocked inputs and the same inputs for the port."""
    st = JaxState.synthetic(ngptot=100, nlev=NLEV)
    blk = st.device_kernel_inputs(NCOL, dtype=np.float32, blocked_sublanes=2)
    tin = inputs_from_numpy(type(blk)(*(_lm(x).T for x in blk)),
                            dtype=torch.float32)
    return dict(state=st, blk=blk, tin=tin, params=params_from_jax(st.params))


# -------------------------------------------------------- encoded NL sweep
@pytest.mark.parametrize("fuse_satur,keep,payload", [
    (True, "default", "int16"),
    (True, "pq", "int16"),
    (False, "default", "int16"),
    (False, "pq", "int16"),
    (True, "pq", "bfloat16"),
    (False, "default", "bfloat16"),
])
def test_plain_nl_encoded_matches_pallas_interpret(jax_side, fuse_satur, keep,
                                                   payload):
    """Both sides decode the same bits; ``("pq",)`` encodes plu and paph too
    (the Pallas kernel's "full" mode, three decode windows)."""
    import jax.numpy as jnp

    st, blk = jax_side["state"], jax_side["blk"]
    jenc = jex.encode_blocked_inputs(
        blk, st.params, keep_f32=KEEPS[keep], fuse_satur=fuse_satur,
        payload_dtype=getattr(jnp, payload))
    want = jex.cloudsc2_pallas_encoded(jenc, st.params, interpret=True)
    enc = _port_encoding(jenc)
    assert enc.fuse_satur == fuse_satur
    kinds = {s.dtype for s in enc.streams}
    assert kinds == {torch.float32, getattr(torch, payload)}
    got = ex.cloudsc2_nl_encoded(enc, jax_side["params"])
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), _lm(b)) < 5e-6, name


@pytest.mark.parametrize("fuse_satur,keep_f32", [
    (True, ("pq", "plu", "paph")),
    (True, ("pq",)),
    (False, ()),
])
def test_bf16_encoder_matches_jax_bit_for_bit(jax_side, fuse_satur, keep_f32):
    import jax.numpy as jnp

    st, blk = jax_side["state"], jax_side["blk"]
    want = _port_encoding(jex.encode_blocked_inputs(
        blk, st.params, fuse_satur=fuse_satur, keep_f32=keep_f32,
        payload_dtype=jnp.bfloat16))
    got = ex.encode_blocked_inputs(jax_side["tin"], jax_side["params"],
                                   fuse_satur=fuse_satur, keep_f32=keep_f32,
                                   payload_dtype=torch.bfloat16)
    assert got.names == want.names
    for name, a, b in zip(got.names, got.streams, want.streams):
        assert a.dtype == b.dtype == (torch.float32 if name in keep_f32
                                      else torch.bfloat16), name
        if a.dtype == torch.bfloat16:
            # the same bits, but for the sign of a zero payload on a level
            # whose values are all +-0 (the two packages' max and min of such
            # a level differ in the sign of their zero)
            differ = a.view(torch.int16) != b.view(torch.int16)
            assert ((a == 0) & (b == 0))[differ].all(), name
        assert torch.equal(a.float(), b.float()), name
    ulp = np.spacing(np.abs(want.enc.numpy()))
    assert (np.abs(got.enc.numpy() - want.enc.numpy()) <= ulp).all()
    assert torch.equal(got.ztrpaus, want.ztrpaus)
    assert torch.equal(got.paphsfc, want.paphsfc)


def test_bf16_payload_is_the_int16_payload_rounded_to_8_bits(jax_side):
    tin, p = jax_side["tin"], jax_side["params"]
    i16 = ex.encode_blocked_inputs(tin, p, keep_f32=())
    b16 = ex.encode_blocked_inputs(tin, p, keep_f32=(),
                                   payload_dtype=torch.bfloat16)
    assert torch.equal(i16.enc, b16.enc)
    for a, b in zip(i16.streams, b16.streams):
        assert a.dtype == torch.int16 and b.dtype == torch.bfloat16
        assert torch.equal(a.float().bfloat16(), b)
        # 8 significant bits: within 2**-8 of the payload, 64x a half step
        assert ((a.float() - b.float()).abs() <= a.float().abs() * 2.0 ** -8).all()
    dec = ex.decode_inputs(b16)
    assert dec.pqs is None and dec.pt.dtype == torch.float32


@pytest.mark.parametrize("keep", ["default", "pq", "all", "none"])
@pytest.mark.parametrize("fuse_satur", [True, False])
def test_encoded_nl_tracks_the_exact_sweep(jax_side, keep, fuse_satur):
    """The JAX test's metric (``tests/test_pallas.py:150-154``): int16
    storage moves each output by less than 5e-4 in L1; with every stream
    kept f32 (the all-f32 control through the same plumbing) nothing
    moves."""
    tin, p = jax_side["tin"], jax_side["params"]
    keep_f32 = KEEPS[keep]
    exact = (kmod.cloudsc2_nl_reference(tin, p) if fuse_satur
             else kmod.cloudsc2_nl_resident_reference(tin, p))
    enc = ex.encode_blocked_inputs(tin, p, keep_f32=keep_f32,
                                   fuse_satur=fuse_satur)
    assert sum(s.dtype == torch.float32 for s in enc.streams) == len(
        [n for n in enc.names if n in keep_f32])
    got = ex.cloudsc2_nl_encoded(enc, p)
    for name, a, b in zip(got._fields, got, exact):
        if keep == "all":
            assert torch.equal(a, b), name
            continue
        a, b = a.double(), b.double()
        assert (a - b).abs().sum() / b.abs().sum().clamp_min(1e-30) < 5e-4, name


def test_encoded_nl_decodes_plu_and_paph_with_their_own_rows(jax_side):
    """plu(k+1) takes the row of level min(k+1, nlev-1), paph(k+1) row k+1 of
    nlev+1, and the ldrain1d branch runs: the plain version on a full
    encoding equals the exact plain sweep on the decoded inputs."""
    tin, p = jax_side["tin"], jax_side["params"]
    enc = ex.encode_blocked_inputs(tin, p, keep_f32=(), fuse_satur=False)
    assert enc.enc.shape == (16, NLEV + 1, 2)
    i = enc.names.index("plu")
    assert torch.equal(enc.enc[i, NLEV], torch.tensor([1.0, 0.0]))  # no such level
    assert (enc.enc[enc.names.index("paph"), NLEV, 0] != 1.0)  # paph has it
    dec = ex.decode_inputs(enc)
    assert dec.paph.shape == (NLEV + 1, NCOL) and dec.plu.shape == (NLEV, NCOL)
    pre = kmod.KernelPrelude(*kmod.level_scalars(p, enc.ztrpaus), enc.ztrpaus,
                             enc.paphsfc)
    want = kmod._nl_sweep(dec, p, True, pqs_stream=True, checkpoints=False,
                          pre=pre)[0]
    got = ex.cloudsc2_nl_encoded(enc, p, ldrain1d=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the exact per-column operands come from before quantisation
    exact_pre = kmod.kernel_prelude(tin, p)
    assert torch.equal(enc.ztrpaus, exact_pre.ztrpaus)
    assert torch.equal(enc.paphsfc, exact_pre.paph_sfc)
    assert not torch.equal(dec.paph[NLEV], enc.paphsfc)


# ------------------------------------------------------- resident NL sweep
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_plain_resident_matches_pallas_interpret(jax_side, ldrain1d):
    st = jax_side["state"]
    std = st.device_kernel_inputs(NCOL, dtype=np.float32)
    want = cloudsc2_pallas(std, st.params, mode="resident", sublanes=2,
                           ldrain1d=ldrain1d, interpret=True)
    got = kmod.unblock_outputs(
        kmod.cloudsc2_nl_resident(jax_side["tin"], jax_side["params"],
                                  ldrain1d=ldrain1d), jax_side["params"])
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) < 5e-6, name


def test_plain_resident_is_the_forward_checkpoint_sweep(jax_side):
    tin, p = jax_side["tin"], jax_side["params"]
    # pqs off SATUR: the sweep must follow the stream, not recompute it
    bumped = tin._replace(pqs=tin.pqs * 1.01)
    for inputs in (tin, bumped):
        got = kmod.cloudsc2_nl_resident(inputs, p, tile=64, depth=3)
        want, _ = kmod.cloudsc2_fwd_ckpt_reference(inputs, p)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    fused = kmod.cloudsc2_nl_reference(bumped, p)
    assert not torch.equal(fused.tenl_q, got.tenl_q)


def test_resident_ring_sizes():
    f32, f64 = torch.float32, torch.float64
    assert kmod.resident_ring(137, f32) == (128, 2, 16 * 1024)
    assert kmod.resident_ring(137, f64) == (128, 2, 32 * 1024)
    assert kmod.resident_ring(137, f32, depth=8) == (128, 8, 64 * 1024)
    # every level resident: 16 streams x 137 levels is 8,768 B a column in f32
    assert kmod.resident_ring(137, f32, tile=26, depth=137) == (26, 137, 227968)
    assert kmod.resident_ring(137, f64, tile=13, depth=500) == (13, 137, 227968)
    assert kmod.resident_ring(5, f32, depth=8) == (128, 5, 5 * 8192)  # nlev < depth
    assert kmod.resident_ring(1, f32) == (128, 1, 8192)
    for bad in (dict(tile=0), dict(tile=257), dict(depth=0)):
        with pytest.raises(ValueError):
            kmod.resident_ring(137, f32, **bad)


# ----------------------------------------------------------- contract errors
def test_nl_experiments_refuse_what_they_do_not_take(jax_side):
    tin, p = jax_side["tin"], jax_side["params"]
    enc = ex.encode_blocked_inputs(tin, p)
    with pytest.raises(ValueError, match="pqs=True"):
        kmod.cloudsc2_nl_resident(tin._replace(pqs=None), p)
    with pytest.raises(ValueError, match="pqs=True"):
        kmod.cloudsc2_nl_resident_reference(tin._replace(pqs=None), p)
    with pytest.raises(ValueError, match="tile"):
        kmod.cloudsc2_nl_resident(tin, p, tile=1000)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmod.launch_cloudsc2_nl_resident(tin, kmod.kernel_prelude(tin, p), p)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmod.cloudsc2_nl_resident(type(tin)(*(x.to("meta") for x in tin)), p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ex.launch_cloudsc2_nl_encoded(enc, p)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ex.cloudsc2_nl_encoded(enc._replace(paphsfc=enc.paphsfc.to("meta")), p)
    f64 = enc._replace(streams=tuple(
        s.double() if s.dtype == torch.float32 else s for s in enc.streams))
    with pytest.raises(TypeError, match="f32 only"):
        ex.cloudsc2_nl_encoded(f64, p)
    with pytest.raises(TypeError, match="f32 only"):
        ex.cloudsc2_nl_encoded(enc._replace(enc=enc.enc.double()), p)
    mixed = list(enc.streams)
    mixed[0] = mixed[0].float().bfloat16()
    with pytest.raises(TypeError, match="one payload dtype"):
        ex.cloudsc2_nl_encoded(enc._replace(streams=tuple(mixed)), p)
    with pytest.raises(ValueError, match="streams"):
        ex.cloudsc2_nl_encoded(enc._replace(streams=enc.streams[:-1]), p)
    with pytest.raises(TypeError, match="payload_dtype"):
        ex.encode_blocked_inputs(tin, p, payload_dtype=torch.float16)
    with pytest.raises(ValueError, match="keep_f32"):
        ex.encode_blocked_inputs(tin, p, keep_f32=("pq", "qp"))
    no_phylin = dataclasses.replace(
        p, yrephli=dataclasses.replace(p.yrephli, lphylin=False))
    with pytest.raises(NotImplementedError):
        ex.cloudsc2_nl_encoded(enc, no_phylin)
    with pytest.raises(NotImplementedError):
        kmod.cloudsc2_nl_resident(tin, no_phylin)
    assert all(torch.isfinite(x).all()
               for x in ex.cloudsc2_nl_encoded(enc, no_phylin, ldrain1d=True))


def test_encoded_tl_and_ad_refuse_the_bf16_payload(jax_side):
    tin, p = jax_side["tin"], jax_side["params"]
    b16 = ex.encode_blocked_inputs(tin, p, fuse_satur=False,
                                   payload_dtype=torch.bfloat16)
    seeds = kmod.Cloudsc2StreamOutputs(*(tin.pt,) * 8)
    with pytest.raises(TypeError, match="int16 payloads only"):
        ex.cloudsc2_tl_encoded(b16, p, dscale=DSCALE)
    with pytest.raises(TypeError, match="int16 payloads only"):
        ex.cloudsc2_ad_encoded(b16, seeds, (tin.pt,) * 3, p)


# --------------------------------------------------- order of the C arguments
def test_new_kernels_take_their_streams_in_the_wrappers_order():
    """The encoded NL launcher passes ``EncodedInputs.names`` then the
    prelude's fields; the resident launcher ``RESIDENT_STREAMS``: both must
    follow ``Order`` of the sweep header, with and without pqs."""
    src = (CSRC / "cloudsc2_nl_sweep.cuh").read_text()
    body = re.search(r"enum : int \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    order = [t.split("=")[0].strip().lower() for t in body.split(",") if t.strip()]
    assert order.pop() == "n"
    tail = list(kmod.KernelPrelude._fields)
    assert order == list(ex.ENCODED_STREAMS) + tail == list(kmod.RESIDENT_STREAMS)
    without = [n for n in order if n != "pqs"]
    assert without[:15] == [n for n in ex.ENCODED_STREAMS if n != "pqs"]
    # the sources name the same layouts in their abi functions
    enc_src = (CSRC / "cloudsc2_nl_enc.cu").read_text()
    assert "counts[0] = Order<false>::N;" in enc_src
    assert "counts[1] = Order<true>::N;" in enc_src
    res_src = (CSRC / "cloudsc2_nl_res.cu").read_text()
    assert "kStaged = O::PAPH + 1" in res_src and kmod._RESIDENT_STAGED == 16
    assert f"kMaxTile = {kmod._RESIDENT_MAX_TILE};" in res_src
    probe_src = (CSRC / "bw_probe.cu").read_text()
    for define in bw_probe.probe_defines(15, 8, (10, 292)):
        assert define.split("=")[0] in probe_src


def test_build_hash_covers_the_defines():
    from cloudsc2jax_torch.kernels import build

    plain = build._build_dir("bw_probe", bw_probe.probe_defines(15, 8))
    other = build._build_dir("bw_probe", bw_probe.probe_defines(16, 8))
    chain = build._build_dir("bw_probe", bw_probe.probe_defines(15, 8, (10, 292)))
    assert len({plain, other, chain, build._build_dir("bw_probe")}) == 4
    assert plain == build._build_dir("bw_probe", list(bw_probe.probe_defines(15, 8)))
    assert build._key("cloudsc2_nl") == ("cloudsc2_nl", (), ())


# ------------------------------------------------------------------- probe
def _numpy_probe(arrs, s, writes, n_trans, n_flops):
    """``tools/bw_probe.py:78-94`` on whole f32 arrays."""
    reads = len(arrs)
    f32 = np.float32
    work = np.zeros_like(arrs[0])
    if n_trans or n_flops:
        work = arrs[0]
        for t in range(n_trans):
            work = np.tanh(work + arrs[t % reads] * f32(1e-3))
        for f in range(max(n_flops - 2 * n_trans, 0) // 2):
            work = work * f32(1.0000001) + arrs[f % reads] * f32(1e-6)
        work = work * f32(1e-20)
    return [arrs[j % reads] * f32(s) + arrs[(j + 1) % reads] + work
            for j in range(writes)]


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("compute", [(0, 0), (2, 10)])
def test_probe_plain_version_matches_the_jax_kernel_body(rev, compute):
    rng = np.random.default_rng(5)
    arrs = [rng.random((5, 768), dtype=np.float32) for _ in range(3)]
    want = _numpy_probe(arrs, 2.0, 2, *compute)
    got = bw_probe.window_stream([torch.from_numpy(a) for a in arrs], 2.0, 2,
                                 rev=rev, compute=compute)
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    # every (level, column) element carries its own data
    assert len(np.unique(got[0].numpy())) > 0.99 * got[0].numel()


@pytest.mark.parametrize("rev", ["0", "1"])
def test_probe_record_matches_the_jax_tool(monkeypatch, capsys, rev):
    for key, value in dict(WINDOWS="3x2", NLEV="5", NB="3", SUBLANES="2",
                           REPEATS="1", INTERPRET="1", REV=rev,
                           COMPUTE="2,10").items():
        monkeypatch.setenv("CLOUDSC2_BW_PROBE_" + key, value)
    want = importlib.import_module("tools.bw_probe").window_probe()
    got = bw_probe.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == got
    assert "INTERPRET is ignored" in err
    for key in ("mode", "windows", "compute_per_element", "rev", "nb",
                "sublanes", "nlev", "traffic_gb_per_call"):
        assert got[key] == want[key], key
    assert got["platform"] == "cpu" and got["columns"] == 3 * 2 * 128
    assert got["traffic_bytes"] == 5 * 5 * 768 * 4
    assert got["ms_per_call"] > 0 and got["attained_gbps"] > 0


def test_probe_plain_stream_and_device_default(monkeypatch, capsys):
    monkeypatch.delenv("CLOUDSC2_BW_PROBE_WINDOWS", raising=False)
    monkeypatch.setenv("CLOUDSC2_BW_PROBE_MB", "1")
    monkeypatch.setenv("CLOUDSC2_BW_PROBE_REPEATS", "2")
    rec = bw_probe.main(["--device", "cpu"])
    assert rec["array_mb"] == 1 and rec["traffic_bytes"] == 3 * 1024 * 1024
    assert rec["traffic_gb_per_call"] == 0.003 and "mode" not in rec
    capsys.readouterr()
    if not torch.cuda.is_available():
        # the entry points run on the card unless asked otherwise
        with pytest.raises(SystemExit, match="no CUDA device"):
            bw_probe.main([])
        with pytest.raises(SystemExit, match="no CUDA device"):
            encoding_study.main([])
    with pytest.raises(ValueError, match="CUDA tensors"):
        bw_probe.launch_window_stream([torch.zeros(2, 3)], 1.0, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bw_probe.window_stream([torch.zeros(2, 3, device="meta")], 1.0, 1)


# ---------------------------------------------------------- encoding study
@pytest.mark.parametrize("scheme", encoding_study.SCHEMES)
def test_quantize_matches_the_jax_tool(scheme):
    jes = importlib.import_module("tools.encoding_study")
    st = JaxState.synthetic(ngptot=100, nlev=NLEV)
    inputs = st.kernel_inputs(dtype=np.float64)
    for name, x in inputs._asdict().items():
        x = np.asarray(x, np.float64)
        with np.errstate(over="ignore"):
            want = jes.quantize(name, x, scheme)
        got = encoding_study.quantize(name, x, scheme)
        assert got.dtype == np.float64 and got.shape == x.shape
        assert np.array_equal(got, np.asarray(want, np.float64), equal_nan=True), name
    with pytest.raises(ValueError):
        encoding_study.quantize("pt", np.zeros((2, 2)), "i8")


def test_encoding_study_table(capsys):
    """DESIGN.md section 8's band for int16 (max field error ~1.5e-4, inside
    the 1.19e-3 validation budget); raw bf16 and f16 storage over budget or
    not finite."""
    table = encoding_study.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(table))
    assert table["budgets"] == encoding_study.BUDGETS
    assert list(table["encodings"]) == ["bf16", "f16", "i16"]
    budget = table["budgets"]["onchip_budget_1e4_eps32"]
    i16 = table["encodings"]["i16"]
    assert 1.0e-4 < i16["max_field_relerr"] < 2.0e-4 < budget
    assert set(i16["per_field"]) == {"tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc",
                                     "pfplsl", "pfplsn", "pfhpsl", "pfhpsn",
                                     "pcovptot"}
    for scheme in ("bf16", "f16"):
        worst = table["encodings"][scheme]["max_field_relerr"]
        assert not (worst <= budget)  # over budget, or NaN
