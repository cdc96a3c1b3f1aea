"""The TPU kernels' other schedules in the port, against the JAX package: the
17-stream adjoint convention (``inplace_scatter=False`` there,
``schedules.cloudsc2_ad_xscat`` here), C levels a step (``chunk_levels``)
for the TL, forward-checkpoint and reverse sweeps (the ``*_chunked``
entries of ``kernels/schedules.py``), and the bfloat16 payload of the
encoded TL and AD sweeps.  The main-path wrappers take no schedule
parameter.

Inputs are the JAX package's synthetic state (nlev 23, 256 columns, f32,
one sublane), fed to both packages, as ``tests/test_torch_tlad.py`` and
``tests/test_pallas_tlad.py:290-345,470-500`` build them; each JAX schedule
runs once per module in interpret mode.  On the CPU the port's wrappers run
the kernels' plain versions.  Tolerances are max |port - jax| / max |jax| per
field: 1e-5 for TL and forward streams, 1e-4 for adjoints (the JAX package's
own bound for its Pallas AD, ``test_pallas_tlad.py:68``), and 1e-4 for the
encoded TL on a bfloat16 encoding: its payloads keep 8 significant bits, and
on the decoded trajectory the cloud cover 1 - sqrt(ratio) takes ratio from
zqsat - zqt at ~6e-4 of their size, where the two frameworks' f32 rounding
moves pclc and the covptot checkpoint by 3.3e-5 (level 16, column 16; the
int16 encoding's worst field is 5.0e-6).  Between the port's own schedules
the results are equal bit for bit: every level runs the same body on the
same values in the same order.
"""

import inspect
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2jax.drivers import DSCALE as JDSCALE
from cloudsc2jax.pallas import experiments as jex
from cloudsc2jax.pallas.tlad_kernel import (
    cloudsc2_pallas_ad,
    cloudsc2_pallas_tl,
    fold_flux_seeds as jfold,
)
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import kernel_ab, onchip_evidence
from cloudsc2jax_torch.convert import (
    encoded_from_numpy,
    inputs_from_numpy,
    params_from_jax,
)
from cloudsc2jax_torch.drivers import DSCALE
from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.kernels import schedules as sch
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _lm(x):
    """Blocked ``(nlev, nb, S, 128)`` -> levels-major ``(nlev, ncol)``."""
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1)


def _streams(tree):
    return type(tree)(*(torch.from_numpy(_lm(x)) for x in tree))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX schedules, each once, in interpret mode: the TL at one level
    a step (its tangents and checkpoints seed every AD below), the AD under
    the 17-stream convention from them and through its own forward sweep,
    the TL and the forward+reverse sweeps at C = 2 and 3, and the encoded
    TL and AD on a bfloat16 encoding."""
    st = JaxState.synthetic(ngptot=100, nlev=23)
    p = st.params
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    kw = dict(lregcl=True, blocked=True, save_checkpoints=True, dscale=JDSCALE,
              interpret=True)
    tl = cloudsc2_pallas_tl(blk, None, p, **kw)
    _, dout, ck = tl
    ad = dict(lregcl=True, blocked=True, inplace_scatter=False, interpret=True)
    xscat = {
        "checkpoints": cloudsc2_pallas_ad(blk, dout, p, checkpoints=ck,
                                          fold_seeds=True, **ad)[1],
        "forward": cloudsc2_pallas_ad(blk, dout, p, **ad)[1],
    }
    folded = jfold(dout, p)
    chunk = {c: (cloudsc2_pallas_tl(blk, None, p, chunk_levels=c, **kw),
                 cloudsc2_pallas_ad(blk, folded, p, lregcl=True, blocked=True,
                                    chunk_levels=c, interpret=True))
             for c in (2, 3)}
    jenc = jex.encode_blocked_inputs(blk, p, fuse_satur=False,
                                     payload_dtype=jnp.bfloat16)
    etl = jex.cloudsc2_pallas_tl_encoded(jenc, p, dscale=JDSCALE, lregcl=True,
                                         interpret=True)
    _, ead = jex.cloudsc2_pallas_ad_encoded(jenc, etl[1], p, checkpoints=etl[2],
                                            lregcl=True, fold_seeds=True,
                                            interpret=True)
    tin = inputs_from_numpy(type(blk)(*(_lm(x).T for x in blk)), dtype=torch.float32)
    return {"params": params_from_jax(p), "tin": tin, "tl": tl, "xscat": xscat,
            "chunk": chunk, "jenc": jenc, "etl": etl, "ead": ead,
            "jax_params": p, "blk": blk}


# ------------------------------------------------ the 17-stream convention
@pytest.mark.parametrize("route", ["checkpoints", "forward"])
def test_plain_xscat_ad_matches_pallas_interpret(jax_side, route):
    """The plain 17-stream AD against ``cloudsc2_pallas_ad(...,
    inplace_scatter=False)``: fed the Pallas TL's tangents and checkpoints
    with the seeds folded in the sweep, and through its own forward sweep
    with the seeds as given."""
    p, tin = jax_side["params"], jax_side["tin"]
    _, jdout, jck = jax_side["tl"]
    seeds = _streams(jdout)
    if route == "checkpoints":
        ckpts = tuple(torch.from_numpy(_lm(x)) for x in jck)
        adj = sch.cloudsc2_ad_xscat(tin, seeds, ckpts, p)
    else:
        _, ckpts = km.cloudsc2_fwd_ckpt(tin, p)
        adj = sch.cloudsc2_ad_xscat(tin, seeds, ckpts, p, fold_seeds=False)
    jadj = jax_side["xscat"][route]
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), _lm(getattr(jadj, n))) < 1e-4, n


@pytest.mark.parametrize("lregcl,fold_seeds", [(True, True), (False, False)])
def test_plain_xscat_ad_equals_the_inplace_ad_bit_for_bit(jax_side, lregcl, fold_seeds):
    """The 17 streams assembled in PyTorch give the in-place scatter's
    adjoints exactly, as ``test_pallas_tlad.py:484`` holds the two TPU
    conventions; the raw streams are what the assembly reads."""
    p, tin = jax_side["params"], jax_side["tin"]
    _, dout, ckpts = tk.cloudsc2_tl(tin, p, dscale=DSCALE, lregcl=lregcl)
    kw = dict(lregcl=lregcl, fold_seeds=fold_seeds)
    inplace = tk.cloudsc2_ad(tin, dout, ckpts, p, **kw)
    xscat = sch.cloudsc2_ad_xscat(tin, dout, ckpts, p, **kw)
    for n in inplace._fields:
        assert torch.equal(getattr(xscat, n), getattr(inplace, n)), n
    raw = sch.cloudsc2_ad_streams_reference(tin, dout, ckpts, p, **kw)
    nlev = tin.pt.shape[0]
    assert raw.paph_sfc.shape == (tin.pt.shape[1],)
    assert all(x.shape == tin.pt.shape for x in raw[:-1])
    # the clamped plu(k+1) read of the last level has a zero cotangent
    assert torch.equal(raw.plu_k1[-1], torch.zeros_like(raw.plu_k1[-1]))
    d_plu, d_paph = sch.assemble_shifted_adjoints(*raw[-4:])
    assert d_plu.shape == (nlev, tin.pt.shape[1]) and d_paph.shape == tin.paph.shape
    assert torch.equal(d_plu, inplace.plu) and torch.equal(d_paph, inplace.paph)


# ---------------------------------------------------------- chunk_levels
@pytest.mark.parametrize("chunk", [2, 3])
def test_plain_chunked_tl_matches_pallas_interpret(jax_side, chunk):
    p, tin = jax_side["params"], jax_side["tin"]
    (jout, jdout, jck), _ = jax_side["chunk"][chunk]
    out, dout, ck = sch.cloudsc2_tl_chunked(tin, p, dscale=DSCALE, chunk_levels=chunk)
    for a, b in zip((*out, *dout, *ck), (*jout, *jdout, *jck)):
        assert _rel(a.numpy(), _lm(b)) < 1e-5


@pytest.mark.parametrize("chunk", [2, 3])
def test_plain_chunked_forward_and_ad_match_pallas_interpret(jax_side, chunk):
    """``cloudsc2_pallas_ad(chunk_levels=C)`` without checkpoints runs the
    chunked forward-checkpoint sweep, then the chunked reverse sweep under
    the 17-stream convention: the port's two plain sweeps at the same C,
    seeded with the same folded tangents."""
    p, tin = jax_side["params"], jax_side["tin"]
    _, (jout, jadj) = jax_side["chunk"][chunk]
    _, jdout, _ = jax_side["tl"]
    out, ckpts = sch.cloudsc2_fwd_ckpt_chunked(tin, p, chunk_levels=chunk)
    for a, b in zip(out, jout):
        assert _rel(a.numpy(), _lm(b)) < 1e-5
    seeds = tk.fold_flux_seeds(_streams(jdout), p)
    adj = sch.cloudsc2_ad_chunked(tin, seeds, ckpts, p, fold_seeds=False,
                                  chunk_levels=chunk)
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), _lm(getattr(jadj, n))) < 1e-4, n


@pytest.mark.parametrize("chunk", [2, 3, 4])
def test_plain_chunked_sweeps_equal_one_level_a_step(jax_side, chunk):
    """Every chunked entry's plain version gives the one-level wrapper's
    results bit for bit at any built C, and so does the standard contract
    assembled from the chunked sweeps against its drop-ins."""
    p, tin = jax_side["params"], jax_side["tin"]
    din = type(tin)(*(DSCALE * x for x in tin))

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    one = tk.cloudsc2_tl(tin, p, dscale=DSCALE)
    many = sch.cloudsc2_tl_chunked(tin, p, dscale=DSCALE, chunk_levels=chunk)
    same((*one[0], *one[1], *one[2]), (*many[0], *many[1], *many[2]))
    same(sum(tk.cloudsc2_tl_din(tin, din, p), ()),
         sum(sch.cloudsc2_tl_din_chunked(tin, din, p, chunk_levels=chunk), ()))
    f1 = km.cloudsc2_fwd_ckpt(tin, p)
    fc = sch.cloudsc2_fwd_ckpt_chunked(tin, p, chunk_levels=chunk)
    same((*f1[0], *f1[1]), (*fc[0], *fc[1]))
    same(tk.cloudsc2_ad(tin, one[1], one[2], p),
         sch.cloudsc2_ad_chunked(tin, one[1], one[2], p, chunk_levels=chunk))
    # the standard contract: its drop-ins against the contract assembled
    # from the chunked sweeps, levels-major
    out, dout = tk.cloudsc2_kernel_tl(tin, din, p, levels_major=True)
    cout, cdout = sch.cloudsc2_tl_din_chunked(tin, din, p, chunk_levels=chunk)
    same((*out, *dout), (*km.unblock_outputs(cout, p, levels_major=True),
                         *km.unblock_outputs(cdout, p, levels_major=True)))
    a1 = tk.cloudsc2_kernel_ad(tin, dout, p, levels_major=True)
    fwd, ckpts = sch.cloudsc2_fwd_ckpt_chunked(tin, p, chunk_levels=chunk)
    adj = sch.cloudsc2_ad_chunked(tin, tk.seed_streams(dout, p, levels_major=True),
                                  ckpts, p, chunk_levels=chunk, fold_seeds=False)
    same((*a1[0], *a1[1]), (*km.unblock_outputs(fwd, p, levels_major=True), *adj))


def test_refusals_mirror_the_jax_package(jax_side):
    """The JAX package refuses write_primal=False and an in-place scatter
    with chunks; the chunked entries offer neither (the chunked TL always
    writes the primal streams, the chunked AD runs the 17-stream
    convention), and refuse a C that no library was built for."""
    p, tin = jax_side["params"], jax_side["tin"]
    _, dout, ck = tk.cloudsc2_tl(tin, p, dscale=DSCALE)
    jp, blk = jax_side["jax_params"], jax_side["blk"]
    # write_primal=False with chunks (tlad_kernel.py:321)
    with pytest.raises(ValueError, match="write_primal"):
        cloudsc2_pallas_tl(blk, None, jp, blocked=True, dscale=JDSCALE,
                           chunk_levels=2, write_primal=False, interpret=True)
    assert "write_primal" not in inspect.signature(sch.cloudsc2_tl_chunked).parameters
    # inplace_scatter with chunks (tlad_kernel.py:664-667)
    with pytest.raises(ValueError, match="inplace_scatter"):
        cloudsc2_pallas_ad(blk, jax_side["tl"][1], jp, blocked=True,
                           checkpoints=jax_side["tl"][2], chunk_levels=2,
                           inplace_scatter=True, interpret=True)
    assert "inplace_scatter" not in inspect.signature(sch.cloudsc2_ad_chunked).parameters
    # a C that no library was built for, on any device
    for call in (lambda: sch.cloudsc2_tl_chunked(tin, p, dscale=DSCALE, chunk_levels=5),
                 lambda: sch.cloudsc2_ad_chunked(tin, dout, ck, p, chunk_levels=0),
                 lambda: sch.cloudsc2_ad_chunked(tin, dout, ck, p, chunk_levels=1),
                 lambda: sch.cloudsc2_fwd_ckpt_chunked(tin, p, chunk_levels=8),
                 lambda: sch.cloudsc2_tl_din_chunked(tin, tin, p, chunk_levels=6)):
        with pytest.raises(ValueError, match="built 2, 3, 4"):
            call()


def test_chunk_levels_are_the_sources_instantiations():
    """The wrappers refuse every C but CHUNK_LEVELS before a launch: the cases
    of the chunked launchers' switches, the only levels a step built."""
    import re

    csrc = Path(km.__file__).resolve().parents[1] / "csrc"
    for name in ("cloudsc2_ad_chunk.cu", "cloudsc2_fwd_chunk.cu",
                 "cloudsc2_tl_sweep.cuh"):
        text = (csrc / name).read_text()
        switch = re.search(r"switch \(chunk\) \{(.*?)default:", text, re.S).group(1)
        cases = tuple(int(c) for c in re.findall(r"case (\d+):", switch))
        assert cases == sch.CHUNK_LEVELS, name
    assert "cloudsc2_tl::launch_chunked" in (csrc / "cloudsc2_tl_chunk.cu").read_text()
    assert "cloudsc2_tl::launch_chunked" in (csrc / "cloudsc2_tl_din_chunk.cu").read_text()


def test_launchers_take_cuda_tensors_only(jax_side):
    p, tin = jax_side["params"], jax_side["tin"]
    pre = km.kernel_prelude(tin, p)
    _, dout, ck = tk.cloudsc2_tl(tin, p, dscale=DSCALE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.launch_cloudsc2_ad_streams(tin, pre, dout, ck, p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.launch_cloudsc2_ad_streams(tin, pre, dout, ck, p, chunk_levels=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.launch_cloudsc2_tl_chunked(tin, pre, p, dscale=DSCALE, chunk_levels=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.launch_cloudsc2_tl_din_chunked(tin, tin, pre, p, chunk_levels=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.launch_cloudsc2_fwd_ckpt_chunked(tin, pre, p, chunk_levels=2)
    meta = type(tin)(*(x.to("meta") for x in tin))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sch.cloudsc2_ad_xscat(meta, dout, ck, p)


# ------------------------------------------------- the bfloat16 payload
@pytest.fixture(scope="module")
def bf16_side(jax_side):
    p, jenc = jax_side["params"], jax_side["jenc"]
    enc = encoded_from_numpy(jenc.streams, jenc.enc, jenc.ztrpaus, jenc.paphsfc)
    tl = ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE)
    return enc, tl


def test_bf16_encoding_is_the_jax_packages(jax_side, bf16_side):
    """The port's encoder on the same inputs gives JAX's bfloat16 payloads
    (the same values; a zero's sign may differ) and its table, and the
    int16 encoding's mask."""
    p, tin = jax_side["params"], jax_side["tin"]
    enc, _ = bf16_side
    mine = ex.encode_blocked_inputs(tin, p, fuse_satur=False,
                                    payload_dtype=torch.bfloat16)
    assert [s.dtype for s in mine.streams] == [s.dtype for s in enc.streams]
    assert sum(s.dtype == torch.bfloat16 for s in enc.streams) == 13
    for a, b in zip(mine.streams, enc.streams):
        assert torch.equal(a.float(), b.float())
    assert torch.equal(mine.enc, enc.enc)
    assert ex.encoded_mask(enc) == ex.encoded_mask(
        ex.encode_blocked_inputs(tin, p, fuse_satur=False))


def test_plain_bf16_encoded_tl_matches_pallas_interpret(jax_side, bf16_side):
    """The plain encoded TL on JAX's bfloat16 encoding of the inputs against
    ``cloudsc2_pallas_tl_encoded`` on it: both decode the same bits (1e-4:
    the module's docstring says why)."""
    jout, jdout, jck = jax_side["etl"]
    out, dout, ck = bf16_side[1]
    for a, b in zip((*out, *dout, *ck), (*jout, *jdout, *jck)):
        assert _rel(a.numpy(), _lm(b)) < 1e-4


def test_plain_bf16_encoded_ad_matches_pallas_interpret(jax_side, bf16_side):
    """The plain encoded AD fed the Pallas encoded TL's tangents and
    checkpoints, against ``cloudsc2_pallas_ad_encoded``."""
    p = jax_side["params"]
    enc = bf16_side[0]
    _, jdout, jck = jax_side["etl"]
    adj = ex.cloudsc2_ad_encoded(enc, _streams(jdout),
                                 tuple(torch.from_numpy(_lm(x)) for x in jck), p)
    jadj = jax_side["ead"]
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), _lm(getattr(jadj, n))) < 1e-4, n


# ----------------------------------------- determinism, harness, battery
def test_plain_versions_are_deterministic():
    """Two runs of each new plain version give the same bits (ROADMAP §1
    item 6 on the CPU; the kernels' half is CUDA-gated)."""
    st = Cloudsc2State.synthetic(ngptot=100, nlev=11)
    p = st.params
    x = st.device_kernel_inputs(100, dtype=torch.float32, device="cpu", pqs=True)
    enc = ex.encode_blocked_inputs(x, p, fuse_satur=False, payload_dtype=torch.bfloat16)
    _, dout, ck = tk.cloudsc2_tl(x, p, dscale=DSCALE)
    runs = {
        "xscat": lambda: sch.cloudsc2_ad_streams_reference(x, dout, ck, p),
        "tl_chunk": lambda: sum(map(tuple, sch.cloudsc2_tl_chunked(
            x, p, dscale=DSCALE, chunk_levels=3)), ()),
        "din_chunk": lambda: sum(sch.cloudsc2_tl_din_chunked(x, x, p, chunk_levels=2), ()),
        "fwd_chunk": lambda: sum(map(tuple, sch.cloudsc2_fwd_ckpt_chunked(
            x, p, chunk_levels=4)), ()),
        "ad_chunk": lambda: sch.cloudsc2_ad_chunked(x, dout, ck, p, chunk_levels=2),
        "tl_bf16": lambda: sum(map(tuple, ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE)), ()),
        "ad_bf16": lambda: ex.cloudsc2_ad_encoded(enc, dout, ck, p),
    }
    for name, run in runs.items():
        first, second = run(), run()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), name


def test_kernel_ab_runs_the_schedules_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CLOUDSC2_AB_NGPTOT", "100")
    monkeypatch.setenv("CLOUDSC2_AB_REPS", "1")
    configs = ["two", "xscat", "chunk:2"]
    summary = kernel_ab.main(configs + ["--nlev", "11"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[:-1]] == ["two", "xscat", "chunk"]
    assert json.loads(lines[-1]) == summary
    assert list(summary["configs"]) == configs
    assert all(r["ms"] > 0 for r in summary["configs"].values())
    for cfg, message in (("chunk", "built 2, 3, 4"), ("chunk:5", "built 2, 3, 4"),
                         ("xscatnp:64", "sublanes")):
        with pytest.raises(ValueError, match=message):
            kernel_ab.main([cfg], device="cpu")


def test_evidence_battery_derives_the_scatter_ratios():
    assert "xscatnp" in onchip_evidence.AB_CONFIGS and "chunk:2" in onchip_evidence.AB_CONFIGS
    d = onchip_evidence.derive({"kernel_ab": {"record": {"configs": {
        "noprim": {"ms": 10.0}, "xscatnp": {"ms": 11.0},
        "two": {"ms": 12.0}, "xscat": {"ms": 13.2}}}}})
    assert d["ab_scatter_speedup_noprim"] == pytest.approx(1.1)
    assert d["ab_scatter_speedup_two"] == pytest.approx(1.1)


# the main-path wrappers of ``cloudsc2_kernel`` and ``tlad_kernel``, which run
# one schedule each (the plain versions and the standard contract's halves
# and drop-ins among them)
MAIN_PATH = (
    "tk.cloudsc2_tl", "tk.cloudsc2_tl_din", "tk.cloudsc2_ad",
    "tk.launch_cloudsc2_tl", "tk.launch_cloudsc2_tl_din", "km.launch_cloudsc2_fwd_ckpt",
    "km.cloudsc2_fwd_ckpt", "tk.cloudsc2_tl_reference", "tk.cloudsc2_ad_reference",
    "km.cloudsc2_fwd_ckpt_reference", "tk.tl_contract", "tk.ad_from_seeds",
    "tk.cloudsc2_kernel_tl", "tk.cloudsc2_kernel_ad", "tk.launch_cloudsc2_ad",
    "km.cloudsc2_nl", "km.launch_cloudsc2_nl", "km.cloudsc2_nl_reference",
)


@pytest.mark.parametrize("name", MAIN_PATH)
def test_main_path_wrappers_take_no_schedule_parameter(name):
    """The schedules are the entries of ``kernels/schedules.py``: no
    main-path wrapper takes C or the scatter convention, and none counts a
    launch of another schedule."""
    module, attr = name.split(".")
    fn = getattr({"tk": tk, "km": km}[module], attr)
    assert not {"chunk_levels", "inplace_scatter"} & set(inspect.signature(fn).parameters)
    assert not {"launches_chunked", "launches_xscat"} & set(vars(fn))
