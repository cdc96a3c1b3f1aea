"""``cloudsc2jax_torch.roofline``: each kernel's bytes are those of the
tensors its plain version reads and writes (at 100 f32 columns and 9
levels, through the wrappers on the CPU), at 327,680 f32 columns × 137
levels they are PERF.md section 3's, and the bounds and shares follow from
the card's published ceilings."""

import json

import pytest
import torch

from cloudsc2jax_torch import bw_probe, roofline
from cloudsc2jax_torch.drivers import DSCALE
from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.kernels import schedules as sch
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State

NCOL, NLEV = 100, 9


def _nbytes(*trees) -> int:
    total = 0
    for t in trees:
        if t is None:
            continue
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        else:
            total += _nbytes(*t)
    return total


@pytest.fixture(scope="module")
def moved():
    """kernel -> the bytes of its plain version's own inputs and outputs."""
    st = Cloudsc2State.synthetic(ngptot=NCOL, nlev=NLEV)
    p = st.params
    nl_in = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cpu")
    x = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cpu", pqs=True)
    pre = km.kernel_prelude(x, p)
    tl = tk.cloudsc2_tl(x, p, dscale=DSCALE)
    dx = type(x)(*(DSCALE * v for v in x))
    enc_nl = ex.encode_blocked_inputs(nl_in, p)
    enc = ex.encode_blocked_inputs(x, p, fuse_satur=False)
    tl_enc = ex.cloudsc2_tl_encoded(enc, p, dscale=DSCALE)
    enc_in = _nbytes(enc.streams, enc.enc, pre)
    b16 = ex.encode_blocked_inputs(x, p, fuse_satur=False,
                                   payload_dtype=torch.bfloat16)
    tl_b16 = ex.cloudsc2_tl_encoded(b16, p, dscale=DSCALE)
    b16_in = _nbytes(b16.streams, b16.enc, pre)
    ad_in = _nbytes(x, pre, tl[1], tl[2])
    arrs = [torch.rand(NLEV, NCOL) for _ in range(15)]
    return {
        "cloudsc2_nl": _nbytes(nl_in, km.kernel_prelude(nl_in, p), km.cloudsc2_nl(nl_in, p)),
        "cloudsc2_nl_res": _nbytes(x, pre, ex.cloudsc2_nl_resident(x, p)),
        "cloudsc2_nl_enc": _nbytes(enc_nl.streams, enc_nl.levels, pre,
                                   ex.cloudsc2_nl_encoded(enc_nl, p)),
        "cloudsc2_fwd_ckpt": _nbytes(x, pre, km.cloudsc2_fwd_ckpt(x, p)),
        "cloudsc2_tl": _nbytes(x, pre, tl),
        "cloudsc2_tl_std": _nbytes(x, pre, tk.cloudsc2_tl_std(x, p, dscale=DSCALE)),
        "cloudsc2_tl_din": _nbytes(x, pre, dx, tk.cloudsc2_tl_din(x, dx, p)[:2]),
        "cloudsc2_ad": _nbytes(x, pre, tl[1], tl[2], tk.cloudsc2_ad(x, tl[1], tl[2], p)),
        "cloudsc2_tlad_fused": _nbytes(x, pre, ex.cloudsc2_tlad_fused(x, p)),
        "cloudsc2_tl_enc": enc_in + _nbytes(tl_enc),
        "cloudsc2_ad_enc": enc_in + _nbytes(
            tl_enc[1], tl_enc[2], ex.cloudsc2_ad_encoded(enc, tl_enc[1], tl_enc[2], p)),
        "bw_probe": _nbytes(arrs, bw_probe.window_stream(arrs, 2.0, 8)),
        "cloudsc2_ad_xscat": ad_in + _nbytes(
            sch.cloudsc2_ad_streams_reference(x, tl[1], tl[2], p)),
        # the chunked kernel writes the 17-stream convention's raw streams
        "cloudsc2_ad_chunk": ad_in + _nbytes(
            sch.cloudsc2_ad_streams_reference(x, tl[1], tl[2], p)),
        "cloudsc2_fwd_chunk": _nbytes(
            x, pre, sch.cloudsc2_fwd_ckpt_chunked(x, p, chunk_levels=2)),
        "cloudsc2_tl_chunk": _nbytes(
            x, pre, sch.cloudsc2_tl_chunked(x, p, dscale=DSCALE, chunk_levels=2)),
        "cloudsc2_tl_din_chunk": _nbytes(
            x, pre, dx, sch.cloudsc2_tl_din_chunked(x, dx, p, chunk_levels=2)),
        "cloudsc2_tl_enc_bf16": b16_in + _nbytes(tl_b16),
        "cloudsc2_ad_enc_bf16": b16_in + _nbytes(
            tl_b16[1], tl_b16[2], ex.cloudsc2_ad_encoded(b16, tl_b16[1], tl_b16[2], p)),
    }


def test_every_kernel_is_described(moved):
    assert set(moved) == set(roofline.KERNELS)


@pytest.mark.parametrize("name", list(roofline.KERNELS))
def test_bytes_are_the_plain_versions_tensors(moved, name):
    assert roofline.nbytes(name, NCOL, NLEV) == moved[name]


# PERF.md section 3: GB per call at 327,680 f32 columns x 137 levels
PERF_GB = {"cloudsc2_nl": 4.134, "cloudsc2_fwd_ckpt": 4.852, "cloudsc2_tl": 6.289,
           "cloudsc2_tl_din": 8.625, "cloudsc2_ad": 7.727, "cloudsc2_tl_enc": 5.122,
           "cloudsc2_ad_enc": 6.560, "cloudsc2_tlad_fused": 8.625,
           "cloudsc2_nl_enc": 3.057, "cloudsc2_nl_res": 4.314, "bw_probe": 4.130}


@pytest.mark.parametrize("name", list(PERF_GB))
def test_headline_bytes_are_perf_section_3(name):
    assert roofline.nbytes(name, 327680, 137) / 1e9 == pytest.approx(PERF_GB[name],
                                                                     rel=1e-3)


def test_bound_and_shares():
    b = roofline.bound("cloudsc2_nl", 327680, 137)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3, rel=1e-15)
    assert b["operations"] == 302 * 137 * 327680
    # the statements of the generated bodies
    assert roofline.operations("cloudsc2_tlad_fused", 1, 1) == (
        roofline.level_statements("tl", False, True)
        + roofline.level_statements("ad", False, True))
    # f64 doubles the bytes and halves the rate of operations
    b64 = roofline.bound("cloudsc2_ad", 16384, 137, "float64")
    assert b64["bytes"] == roofline.nbytes("cloudsc2_ad", 16384, 137, itemsize=8)
    slow = roofline.bound_of(1, 34e12 * 1e-3, "float64")
    assert slow["bound_by"] == "operations" and slow["bound_ms"] == pytest.approx(1.0)
    r = roofline.report("cloudsc2_nl", 327680, 137, ms=2 * b["bound_ms"],
                        ceiling_gbps=2500.0)
    assert r["share_of_bound"] == pytest.approx(0.5)
    assert r["attained_gbps"] == pytest.approx(3350.0 / 2)
    assert r["share_of_ceiling"] == pytest.approx(3350.0 / 2500.0 / 2)


def test_main_prints_one_line_per_kernel(capsys):
    assert roofline.main(["cloudsc2_tl", "bw_probe", "--ms", "3.0",
                          "--bytes-per-s", "3e12"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["kernel"] for x in lines] == ["cloudsc2_tl", "bw_probe"]
    assert lines[0]["bound_ms"] == pytest.approx(lines[0]["bytes"] / 3e12 * 1e3)
    assert roofline.main([]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(roofline.KERNELS)
    with pytest.raises(SystemExit):
        roofline.main(["no_such_kernel"])
