"""The encoded NL kernel's launch contract, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``).  What its
launcher builds and chooses, and what its source states, is checked here:

* the level-major decode table of a 15-stream (``fuse_satur``) encoding,
  carried over from the JAX package, padded to 16 pairs a level;
* the default encoding's masks of both stream orders against the constants
  of ``csrc/cloudsc2_nl_enc.cu``, read from the source;
* the NL sweep's never-encoded set, empty: an encoded plu or paph is decoded;
* the launcher's choice of kernel by mask (``nl_encoded_kernel``);
* the register budget's define, through which ``probes/nl_enc_ab.py``
  rebuilds the library;
* the window probe's 16-bit reads, through which ``probes/nl_enc_shape.py``
  measures the encoded sweep's own access shape.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from cloudsc2jax.pallas import experiments as jex
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import bw_probe
from cloudsc2jax_torch.convert import encoded_from_numpy
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.probes import nl_enc_ab, nl_enc_shape
from cloudsc2jax_torch.state import Cloudsc2State

CSRC = pathlib.Path(ex.__file__).resolve().parents[1] / "csrc"
KEEPS = {"default": ex._KEEP_F32, "pq": ("pq",), "none": (),
         "all": ex.ENCODED_STREAMS}
PAYLOADS = {"int16": torch.int16, "bfloat16": torch.bfloat16}


def _source():
    return (CSRC / "cloudsc2_nl_enc.cu").read_text()


@pytest.fixture(scope="module")
def port_state():
    return Cloudsc2State.synthetic(ngptot=40, nlev=23)


def _encode(st, fuse_satur, keep="default", payload="int16"):
    inputs = st.device_kernel_inputs(40, dtype=torch.float32, device="cpu", pqs=True)
    return ex.encode_blocked_inputs(inputs, st.params, fuse_satur=fuse_satur,
                                    keep_f32=KEEPS[keep],
                                    payload_dtype=PAYLOADS[payload])


def test_level_major_table_of_a_fuse_satur_encoding_from_the_jax_package():
    st = JaxState.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    jenc = jex.encode_blocked_inputs(blk, st.params, fuse_satur=True)
    enc = encoded_from_numpy(jenc.streams, jenc.enc, jenc.ztrpaus, jenc.paphsfc)
    table = np.asarray(jenc.enc, np.float32)[:-1]  # the TPU's duplicated row
    n, rows, _ = table.shape
    assert n == 15 and enc.fuse_satur
    assert enc.levels.shape == (rows, 16, 2)
    np.testing.assert_array_equal(enc.levels[:, :n].numpy(),
                                  table.transpose(1, 0, 2))
    assert (enc.levels[:, n:, 0] == 1).all() and (enc.levels[:, n:, 1] == 0).all()


@pytest.mark.parametrize("payload", ["int16", "bfloat16"])
@pytest.mark.parametrize("fuse_satur,constant", [(True, "kDefaultMaskFused"),
                                                 (False, "kDefaultMaskStreamed")])
def test_nl_default_masks_follow_the_cuda_source(port_state, fuse_satur,
                                                 constant, payload):
    m = re.search(rf"constexpr unsigned {constant} = (0x[0-9A-Fa-f]+)u;", _source())
    mask = int(m.group(1), 16)
    assert mask == ex.NL_DEFAULT_MASKS[fuse_satur] == (0x1FFD if fuse_satur else 0x3FFD)
    enc = _encode(port_state, fuse_satur, payload=payload)
    assert ex.encoded_mask(enc) == mask
    # every stream of the order but pq, plu and paph holds payloads
    assert mask == sum(1 << j for j, n in enumerate(enc.names)
                       if n not in ex._KEEP_F32)


@pytest.mark.parametrize("fuse_satur", [True, False])
def test_nl_sweep_never_encodes_no_stream(port_state, fuse_satur):
    """Both NL kernels instantiate the level-major policy with an empty
    never-encoded set, so an encoded plu or paph reaches a decode (the TL
    and AD sweeps' kNeverEncoded would read them as f32)."""
    src = _source()
    assert "constexpr unsigned kNlNeverEncoded = 0u;" in src
    assert "cloudsc2_load::LevelMajorT<FIXED, kNlNeverEncoded, BF16, true>" in src
    assert src.count("LevelMajorT<") == 1
    enc = _encode(port_state, fuse_satur, keep="none")
    names = enc.names
    mask = ex.encoded_mask(enc)
    for name in ("plu", "paph"):
        j = names.index(name)
        assert enc.streams[j].dtype == torch.int16 and (mask >> j) & 1
        # the plain decode of the payload lands within one step of the
        # exact field, level by level
        decoded = getattr(ex.decode_inputs(enc), name)
        exact = getattr(port_state.device_kernel_inputs(
            40, dtype=torch.float32, device="cpu", pqs=True), name)
        step = enc.enc[j, : exact.shape[0], 0:1]
        assert not torch.equal(decoded, enc.streams[j].float())
        assert ((decoded - exact).abs() <= step).all()
    assert ex.nl_encoded_kernel(enc) == "runtime"


@pytest.mark.parametrize("fuse_satur", [True, False])
@pytest.mark.parametrize("keep,payload,kernel", [
    ("default", "int16", "fixed"), ("default", "bfloat16", "fixed"),
    ("pq", "int16", "runtime"), ("none", "int16", "runtime"),
    ("pq", "bfloat16", "runtime"), ("all", "int16", "runtime"),
])
def test_launcher_picks_the_kernel_by_mask(port_state, fuse_satur, keep, payload,
                                           kernel):
    enc = _encode(port_state, fuse_satur, keep, payload)
    assert ex.nl_encoded_kernel(enc) == kernel
    # the runtime-mask kernel takes every mask, the fixed one only its own
    assert ex.nl_encoded_kernel(enc, "runtime") == "runtime"
    if kernel == "fixed":
        assert ex.nl_encoded_kernel(enc, "fixed") == "fixed"
    else:
        with pytest.raises(ValueError, match="no encoded NL kernel"):
            ex.nl_encoded_kernel(enc, "fixed")
        # the launcher asks the helper before it looks at the device
        with pytest.raises(ValueError, match="no encoded NL kernel"):
            ex.launch_cloudsc2_nl_encoded(enc, port_state.params, kernel="fixed")
    with pytest.raises(ValueError, match="no encoded NL kernel"):
        ex.nl_encoded_kernel(enc, "plain")


@pytest.mark.parametrize("blocks", nl_enc_ab.SWEEP)
def test_budget_define_rebuilds_the_encoded_nl_library(blocks):
    src = _source()
    macro = nl_enc_ab.BUDGET
    assert f"#ifndef {macro}" in src and f"__launch_bounds__(kThreads, {macro})" in src
    defines = nl_enc_ab.variants_of(["sweep"])[f"b{blocks}"]
    assert defines == (f"{macro}={blocks}",)
    lib = nl_enc_ab.LIBRARY
    assert build._build_dir(lib, defines) != build._build_dir(lib)
    with build.variant(lib, defines):
        assert build._key(lib) == (lib, defines, ())
    assert build._key(lib) == (lib, (), ())


def test_probe_marks_name_the_encoded_nl_kernels():
    """The A/B probe finds the fixed kernel of the default mask and the
    runtime-mask kernel by their template arguments."""
    assert "template <bool EVAP, bool PQS_STREAM, bool BF16, unsigned FIXED>" in _source()
    assert nl_enc_ab.MARKS["fixed"][1].endswith(f"Lj{ex.NL_DEFAULT_MASKS[True]}E")
    assert nl_enc_ab.MARKS["runtime"][1].endswith("Lj0E")
    assert set(nl_enc_ab.CHECKED) >= set(nl_enc_ab.TIMED)


@pytest.mark.parametrize("mix", sorted(nl_enc_shape.MIXES))
def test_shape_probe_builds_the_window_probe_at_the_encoded_mix(mix):
    """``probes/nl_enc_shape.py`` builds ``csrc/bw_probe.cu`` with its first
    ``BW_PROBE_R16`` reads int16; the default encoding's mix is 12 of 15."""
    src = (CSRC / "bw_probe.cu").read_text()
    assert "#ifndef BW_PROBE_R16" in src and "constexpr int R16 = BW_PROBE_R16;" in src
    r16, compute = nl_enc_shape.MIXES[mix]
    assert 0 <= r16 <= nl_enc_shape.READS and compute in ((0, 0), (10, 292))
    defines = bw_probe.probe_defines(nl_enc_shape.READS, nl_enc_shape.WRITES,
                                     compute) + (f"BW_PROBE_R16={r16}",)
    assert build._build_dir("bw_probe", defines) != build._build_dir(
        "bw_probe", defines[:-1])
    default_payloads = sum(n not in ex._KEEP_F32 for n in ex.ENCODED_STREAMS
                           if n != "pqs")
    assert nl_enc_shape.MIXES["i16x12"][0] == default_payloads == 12
