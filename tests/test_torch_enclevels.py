"""The encoded TL and AD kernels' launch contract, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What their launchers build and what their sources state is checked here:

* the level-major decode table (``EncodedInputs.levels``, ``level_major``)
  against ``EncodedInputs.enc`` element for element, for the port's encoder
  and for an encoding carried over from the JAX package;
* the never-encoded streams and the default encoding's mask against the
  constants of ``csrc/cloudsc2_load.cuh``, read from the source;
* the budget probe's encoded libraries against their sources' defines;
* the SASS helpers of ``kernels/build.py`` on a listing in
  ``cuobjdump -sass``'s format.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from cloudsc2jax.pallas import experiments as jex
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch.convert import encoded_from_numpy
from cloudsc2jax_torch.drivers import DSCALE
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.probes import tlad_budget
from cloudsc2jax_torch.state import Cloudsc2State

CSRC = pathlib.Path(ex.__file__).resolve().parents[1] / "csrc"
KEEPS = [("pq", "plu", "paph"), ("pq", "plu", "paph", "pt", "pmfu")]


def _load_header():
    return (CSRC / "cloudsc2_load.cuh").read_text()


@pytest.fixture(scope="module")
def port_state():
    return Cloudsc2State.synthetic(ngptot=40, nlev=23)


def _encode(st, keep_f32, fuse_satur=False):
    inputs = st.device_kernel_inputs(40, dtype=torch.float32, device="cpu", pqs=True)
    return ex.encode_blocked_inputs(inputs, st.params, fuse_satur=fuse_satur,
                                    keep_f32=keep_f32)


@pytest.mark.parametrize("keep_f32", KEEPS)
@pytest.mark.parametrize("fuse_satur", [False, True])
def test_level_major_table_holds_enc(port_state, keep_f32, fuse_satur):
    enc = _encode(port_state, keep_f32, fuse_satur)
    n, rows, _ = enc.enc.shape
    lv = enc.levels
    assert n == (15 if fuse_satur else 16)
    assert lv.device == enc.enc.device and lv.dtype == torch.float32
    assert lv.is_contiguous() and tuple(lv.shape) == (rows, 16, 2)
    for row in range(rows):
        for stream in range(n):
            assert torch.equal(lv[row, stream], enc.enc[stream, row])
        # a 15-stream encoding's rows are padded with the pair (1, 0)
        for stream in range(n, 16):
            assert lv[row, stream].tolist() == [1.0, 0.0]
    # one level's pairs side by side: 16 x 8 B = 128 B per level, read as
    # float4 pairs of streams
    assert lv.stride() == (32, 2, 1) and lv.data_ptr() % 16 == 0


def test_level_major_table_of_an_encoding_from_the_jax_package():
    st = JaxState.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    jenc = jex.encode_blocked_inputs(blk, st.params, fuse_satur=False)
    enc = encoded_from_numpy(jenc.streams, jenc.enc, jenc.ztrpaus, jenc.paphsfc)
    table = np.asarray(jenc.enc, np.float32)[:-1]  # the TPU's duplicated row
    assert enc.levels.shape == (table.shape[1], table.shape[0], 2)
    np.testing.assert_array_equal(enc.levels.numpy(), table.transpose(1, 0, 2))
    np.testing.assert_array_equal(enc.levels.numpy(),
                                  enc.enc.transpose(0, 1).numpy())


def test_never_encoded_streams_follow_the_cuda_source():
    m = re.search(r"constexpr unsigned kNeverEncoded = ([^;]+);", _load_header())
    bits = [int(b) for b in re.findall(r"1u << (\d+)", m.group(1))]
    assert {ex.ENCODED_STREAMS[b] for b in bits} == set(ex._KEEP_F32)
    # the TL and AD sweeps number their streams as the encoding does
    for sweep in ("cloudsc2_tl_sweep.cuh", "cloudsc2_ad_sweep.cuh"):
        src = (CSRC / sweep).read_text()
        body = re.search(r"enum Stream \{([^}]*)\}", src).group(1)
        names = [t.strip() for t in body.replace("\n", " ").split(",")]
        assert [n.lower()[2:] for n in names[:16]] == list(ex.ENCODED_STREAMS)


@pytest.mark.parametrize("stream", ["pq", "plu", "paph"])
def test_encoded_sweeps_refuse_a_never_encoded_stream(port_state, stream):
    keep = tuple(s for s in ex._KEEP_F32 if s != stream)
    enc = _encode(port_state, keep)
    assert enc.streams[ex.ENCODED_STREAMS.index(stream)].dtype == torch.int16
    with pytest.raises(ValueError, match=f"keeps {stream} f32"):
        ex.cloudsc2_tl_encoded(enc, port_state.params, dscale=DSCALE)


def test_default_encoding_runs_the_fixed_mask_kernel(port_state):
    """The default encoding's mask is the one the launchers give a kernel of
    its own (kDefaultMask); any other keep_f32 runs the runtime mask."""
    src = _load_header()
    streams = int(re.search(r"constexpr int kTableStreams = (\d+);", src).group(1))
    assert streams == len(ex.ENCODED_STREAMS)
    assert ("constexpr unsigned kDefaultMask = ((1u << kTableStreams) - 1u) & "
            "~kNeverEncoded;") in src
    never = sum(1 << ex.ENCODED_STREAMS.index(n) for n in ex._KEEP_F32)
    default = ((1 << streams) - 1) & ~never
    assert ex.encoded_mask(_encode(port_state, ex._KEEP_F32)) == default == 0x3FFD
    assert ex.encoded_mask(_encode(port_state, KEEPS[1])) != default
    assert f"ILj{default}E" in tlad_budget.ENTRY["tl_enc"][1]


def test_plain_encoded_versions_need_no_level_major_table(port_state):
    enc = _encode(port_state, KEEPS[0])
    out = ex.cloudsc2_tl_encoded(enc, port_state.params, dscale=DSCALE)
    bare = ex.cloudsc2_tl_encoded(enc._replace(levels=None), port_state.params,
                                  dscale=DSCALE)
    for a, b in zip(out, bare):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["tl_enc", "ad_enc"])
def test_budget_probe_builds_the_encoded_libraries(kind):
    src = (CSRC / f"{tlad_budget.LIBRARY[kind]}.cu").read_text()
    (define,) = tlad_budget.budget_defines(kind, 7)
    macro = define.split("=")[0]
    assert f"#ifndef {macro}" in src and f"__launch_bounds__(kThreads, {macro})" in src
    kernel, mark = tlad_budget.ENTRY[kind]
    assert f"{kernel}(const __grid_constant__ Args<float> a" in src
    # the work unit's entry: the default encoding's kernel
    assert "EncodedLevelsT<kDefaultMask>" in src
    assert mark.endswith("14EncodedLevelsTILj16381EEE")
    assert set(tlad_budget.SWEEP) == set(tlad_budget.LIBRARY) == set(tlad_budget.ENTRY)


_LISTING = """
\tcode for sm_90a
\t\tFunction : _Z4loopPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe40000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;              /* 0x0000000404027981 */
                                                                             /* 0x000ea2000c1e1900 */
        /*0020*/                   LDC.64 R6, c[0x0][R3+0x210] ;             /* 0x0000840003067b82 */
                                                                             /* 0x000e220000000a00 */
        /*0030*/                   FADD R2, R2, R6 ;                         /* 0x0000000602027221 */
                                                                             /* 0x004fca0000000000 */
        /*0040*/               @P0 BRA 0x10 ;                                /* 0x0000000000000947 */
                                                                             /* 0x000fea000383ffff */
        /*0050*/                   EXIT ;                                    /* 0x000000000000794d */
                                                                             /* 0x000fea0003800000 */
\t\tFunction : _Z4copyPf
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;              /* 0x0000000404027981 */
                                                                             /* 0x000ea2000c1e1900 */
        /*0010*/                   EXIT ;                                    /* 0x000000000000794d */
                                                                             /* 0x000fea0003800000 */
"""


def test_sass_helpers_read_a_cuobjdump_listing():
    digests = build.sass_digests(_LISTING)
    assert set(digests) == {"_Z4loopPf", "_Z4copyPf"}
    assert len(set(digests.values())) == 2
    changed = _LISTING.replace("FADD R2, R2, R6", "FMUL R2, R2, R6")
    again = build.sass_digests(changed)
    assert again["_Z4copyPf"] == digests["_Z4copyPf"]
    assert again["_Z4loopPf"] != digests["_Z4loopPf"]
    assert build.library_digest(digests) == build.library_digest(dict(digests))
    assert build.library_digest(again) != build.library_digest(digests)
    census = build.loop_census(_LISTING, ["loop"])
    assert census == {"instructions": 4,
                      "ops": {"LDG": 1, "LDC": 1, "FADD": 1, "BRA": 1}}
    with pytest.raises(AssertionError, match="no loop"):
        build.loop_census(_LISTING, ["copy"])
