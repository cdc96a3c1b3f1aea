"""The scheduling experiments over 16-bit-encoded streams, the fused unit
and the resident NL sweep: the stream encoder, the encoded NL, TL and AD
sweeps, the single-launch fused TL+AD unit and the shared-memory-staged NL
sweep.

Port of :mod:`cloudsc2jax.pallas.experiments` and of the resident mode of
:mod:`cloudsc2jax.pallas.cloudsc2_kernel`.  None of these is on a
production path; :mod:`cloudsc2jax_torch.kernel_ab` runs the TL+AD ones
beside the two-kernel unit (:func:`~cloudsc2jax_torch.drivers.run_tlad`) on
one set of inputs and prints one timing line per schedule, and
``chip_smoke.py`` times the encoded and resident NL sweeps beside the exact
one.

* :class:`EncodedInputs` and :func:`encode_blocked_inputs` (the JAX
  package's names; "blocked" is its word for the stream contract, which
  here is levels-major ``(nlev, ncol)``): per stream and level an affine
  16-bit anomaly, ``offset`` the midrange and ``scale`` the halfrange over
  32767 across all columns, stored as int16 or, with
  ``payload_dtype=torch.bfloat16``, as the bfloat16 nearest to the same
  rounded anomaly (the JAX package's convert-cost control: same bytes, a
  shift in place of a convert, 64x coarser).  Plain PyTorch on the inputs'
  device, as the JAX package computes it outside any kernel.  The table is
  the compact ``(n_streams, nlev+1, 2)`` f32 ``[scale, offset]`` array: the
  TPU's lane-broadcast rows (``enc_table_rows``) and its duplicated
  paph(k+1) row have no counterpart, a thread reads two scalars per stream
  and level.  The encoder also keeps it level-major
  (``EncodedInputs.levels``, :func:`level_major`, 16 pairs a level, a
  15-stream table padded), made once per encoding: the encoded kernels read
  one level's pairs from one 128 B line.
* :func:`decode_inputs` and the plain versions
  :func:`cloudsc2_nl_encoded_reference` (decode, then the plain NL sweep,
  with SATUR or the decoded pqs stream as the encoding has it),
  :func:`cloudsc2_tl_encoded_reference`, :func:`cloudsc2_ad_encoded_reference`
  (decode, then the plain TL / AD sweep), each on the decoded trajectory with
  the encoder's exact tropopause eta and surface pressure, and
  :func:`cloudsc2_tlad_fused_reference` (the plain TL then the plain AD with
  folded seeds, after one :func:`plain_prelude`).
* :func:`cloudsc2_nl_encoded`, :func:`cloudsc2_tl_encoded`,
  :func:`cloudsc2_ad_encoded` and :func:`cloudsc2_tlad_fused` are the
  wrappers.  CUDA tensors go to the hand-written kernels
  (``csrc/cloudsc2_nl_enc.cu``, ``csrc/cloudsc2_tl_enc.cu``,
  ``csrc/cloudsc2_ad_enc.cu``, ``csrc/cloudsc2_tlad_fused.cu``), CPU tensors
  to the plain versions, any other device raises.  Each counts its kernel
  launches in ``.launches``.
* :func:`cloudsc2_nl_resident` is the wrapper of the shared-memory-staged
  sweep, the port of ``_resident_kernel`` (``mode="resident"``): the sweep
  with ``inputs.pqs`` read as a stream, no checkpoints, its kernel
  ``csrc/cloudsc2_nl_res.cu`` copying ``depth`` levels of a ``tile``-column
  block ahead of the arithmetic into a ring in shared memory
  (:func:`resident_ring`); its plain version is
  :func:`cloudsc2_nl_resident_reference`.

The encoded sweeps are f32 only.  The NL sweep takes any subset of its
streams encoded, plu and paph included, either payload, and both
``fuse_satur`` settings (``cloudsc2_pallas_encoded``,
``experiments.py:164``); the default encoding's mask of each stream order
runs a kernel of its own (:func:`nl_encoded_kernel`).  The TL and AD sweeps
keep ``pq``, ``plu`` and ``paph`` as f32 streams, as in the JAX package
(``_EncGeometry``, ``experiments.py:515-536``), and take either payload, one
per encoding: int16 runs ``csrc/cloudsc2_{tl,ad}_enc.cu``, bfloat16
``csrc/cloudsc2_{tl,ad}_enc_bf16.cu`` (counted in ``.launches_bf16``); the
fused unit runs in float and double.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs
from . import build, fused_plan
from . import tlad_kernel as tk
from .cloudsc2_kernel import (
    KERNEL_CONSTANTS,
    KERNEL_OUTPUTS,
    KERNEL_STREAMS,
    Checkpoints,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _NL_ARGTYPES,
    _check_config,
    _evap,
    _kernel_constants,
    _launch,
    _nl_sweep,
    check_operands,
    kernel_prelude,
    level_scalars,
    plain_prelude,
)

__all__ = [
    "ENCODED_STREAMS",
    "FUSED_OUTPUTS",
    "RESIDENT_STREAMS",
    "EncodedInputs",
    "cloudsc2_ad_encoded",
    "cloudsc2_ad_encoded_reference",
    "cloudsc2_nl_encoded",
    "cloudsc2_nl_encoded_reference",
    "cloudsc2_nl_resident",
    "cloudsc2_nl_resident_reference",
    "cloudsc2_tl_encoded",
    "cloudsc2_tl_encoded_reference",
    "cloudsc2_tlad_fused",
    "cloudsc2_tlad_fused_reference",
    "decode_inputs",
    "encode_blocked_inputs",
    "encoded_mask",
    "fused_launch_plan",
    "launch_cloudsc2_ad_encoded",
    "launch_cloudsc2_nl_encoded",
    "launch_cloudsc2_nl_resident",
    "launch_cloudsc2_tl_encoded",
    "launch_cloudsc2_tlad_fused",
    "level_major",
    "nl_encoded_kernel",
    "resident_ring",
]

# the 16 streams of a `fuse_satur=False` encoding, in the kernels' pointer
# order (the first 16 of TL_STREAMS)
ENCODED_STREAMS = _LEVEL_FIELDS + ("plu", "paph")
_KEEP_F32 = ("pq", "plu", "paph")
PAYLOAD_DTYPES = (torch.int16, torch.bfloat16)
# [scale, offset] pairs per level of the level-major table (kTableStreams of
# csrc/cloudsc2_load.cuh): one 128 B line
TABLE_STREAMS = 16
# the default encoding's enc_mask in each NL stream order, by fuse_satur
# (kDefaultMaskFused, kDefaultMaskStreamed of csrc/cloudsc2_nl_enc.cu): the
# masks that have a kernel of their own
NL_DEFAULT_MASKS = {True: 0x1FFD, False: 0x3FFD}
# pointer order of the fused launcher's outputs (enum Output in
# csrc/cloudsc2_tlad_fused.cu)
FUSED_OUTPUTS = (KERNEL_OUTPUTS + tuple("d_" + n for n in KERNEL_OUTPUTS)
                 + tk.AD_OUTPUTS)
# the resident sweep takes pqs in its place among the level fields
# (Order<true>), the order of the TL and AD sweeps
RESIDENT_STREAMS = _LEVEL_FIELDS + KERNEL_STREAMS[len(_LEVEL_FIELDS) - 1:]
# its default block and ring: 128 columns x 2 levels in flight, the fastest of
# the rings measured on an NVIDIA H100 (PERF.md): a deeper ring takes shared
# memory that costs more warps per SM than its lookahead gains
RESIDENT_TILE = 128
RESIDENT_DEPTH = 2
# streams staged per level and the largest block of csrc/cloudsc2_nl_res.cu
_RESIDENT_STAGED = len(_LEVEL_FIELDS) + 2
_RESIDENT_MAX_TILE = 256


# ------------------------------------------------------------------ encoder
class EncodedInputs(NamedTuple):
    """Stream-contract operands with 16-bit affine-encoded level streams.

    ``streams`` follows the kernels' operand order: the 14 level fields
    (``pqs`` dropped when ``fuse_satur``), then plu, paph; each is a
    levels-major ``(nlev, ncol)`` tensor (paph ``(nlev+1, ncol)``), int16
    (or bfloat16, one payload dtype per encoding) where encoded and f32
    where kept.  ``enc`` is the ``(n_streams, nlev+1,
    2)`` f32 ``[scale, offset]`` table, row (1, 0) for a kept stream and
    for the level a stream does not have.  ``ztrpaus`` and ``paphsfc`` are
    the per-column f32 operands, computed before quantisation.  ``levels``
    is :func:`level_major` of ``enc``: the same table level-major,
    ``(nlev+1, 16, 2)`` (a 15-stream table padded with pairs (1, 0)), on
    the same device, which the encoded kernels read (None: the encoding
    cannot be launched there; the plain versions do not read it).
    """

    streams: Tuple[torch.Tensor, ...]
    enc: torch.Tensor
    ztrpaus: torch.Tensor
    paphsfc: torch.Tensor
    levels: Optional[torch.Tensor] = None

    @property
    def fuse_satur(self) -> bool:
        return len(self.streams) == len(_LEVEL_FIELDS) + 1

    @property
    def names(self) -> Tuple[str, ...]:
        """The input field each stream holds."""
        return tuple(n for n in ENCODED_STREAMS
                     if not (self.fuse_satur and n == "pqs"))


def encode_blocked_inputs(
    inputs: Cloudsc2Inputs, params: Params, *,
    keep_f32: Sequence[str] = _KEEP_F32, fuse_satur: bool = True,
    payload_dtype: torch.dtype = torch.int16,
) -> EncodedInputs:
    """Quantise levels-major input streams to 16-bit per-(field, level)
    affine anomalies (``encode_blocked_inputs``, ``experiments.py:97``).

    For each stream and level, over all columns, in f32: ``offset = 0.5 *
    (max + min)``, ``scale = max((max - min) / 65534, 1e-30)``, payload
    ``clip(round_half_even((x - offset) / scale), -32767, 32767)`` stored
    as ``payload_dtype``: int16 holds it exactly, bfloat16 rounds it to 8
    significant bits (the encoded NL sweep's convert-cost control).
    Streams named in ``keep_f32`` stay f32, any subset of the names.  ``fuse_satur`` drops ``pqs``
    (the NL sweep computes it); the TL and AD sweeps need it kept.  The
    tropopause eta and the surface pressure come from the exact inputs
    (:func:`kernel_prelude`), before quantisation.
    """
    if payload_dtype not in PAYLOAD_DTYPES:
        raise TypeError(f"payload_dtype must be torch.int16 or torch.bfloat16, "
                        f"got {payload_dtype}")
    names = [n for n in ENCODED_STREAMS if not (fuse_satur and n == "pqs")]
    unknown = sorted(set(keep_f32) - set(ENCODED_STREAMS))
    if unknown:
        raise ValueError(f"keep_f32 names no stream: {unknown}")
    exact = Cloudsc2Inputs(*(None if x is None else x.float() for x in inputs))
    nlev = exact.pt.shape[0]
    enc = exact.pt.new_zeros((len(names), nlev + 1, 2))
    enc[:, :, 0] = 1.0
    streams = []
    for i, name in enumerate(names):
        x = getattr(exact, name)
        if x is None:
            raise ValueError(f"encode_blocked_inputs needs {name}"
                             + (": build the inputs with pqs=True"
                                if name == "pqs" else ""))
        if name in keep_f32:
            streams.append(x.contiguous())
            continue
        lo, hi = x.amin(dim=1), x.amax(dim=1)
        off = 0.5 * (hi + lo)
        scale = torch.clamp_min((hi - lo) / 65534.0, 1e-30)
        payload = torch.round((x - off[:, None]) / scale[:, None])
        streams.append(payload.clamp_(-32767, 32767).to(payload_dtype))
        enc[i, : x.shape[0], 0] = scale
        enc[i, : x.shape[0], 1] = off
    pre = kernel_prelude(exact, params)
    return EncodedInputs(streams=tuple(streams), enc=enc,
                         ztrpaus=pre.ztrpaus, paphsfc=pre.paph_sfc.contiguous(),
                         levels=level_major(enc))


def level_major(enc: torch.Tensor) -> torch.Tensor:
    """The ``(n_streams, nlev+1, 2)`` table ``enc`` level-major, ``(nlev+1,
    16, 2)`` contiguous on its device: one level's pairs side by side, a
    15-stream table padded with a 16th pair (1, 0), so that every level is
    one 128 B line the encoded kernels read as float4 pairs.  The encoder
    makes it once per encoding, outside any launch."""
    n, rows, _ = enc.shape
    if n == TABLE_STREAMS:
        return enc.transpose(0, 1).contiguous()
    out = enc.new_zeros((rows, TABLE_STREAMS, 2))
    out[:, n:, 0] = 1.0
    out[:, :n] = enc.transpose(0, 1)
    return out


def decode_inputs(enc: EncodedInputs) -> Cloudsc2Inputs:
    """The f32 trajectory the encoded sweeps run on: ``float(q) * scale +
    offset`` per level for an int16 or bfloat16 stream, multiply and add
    rounded separately; a kept stream as it is; ``pqs`` ``None`` for a
    ``fuse_satur`` encoding."""
    out = {"pqs": None}
    for i, (name, s) in enumerate(zip(enc.names, enc.streams)):
        if s.dtype in PAYLOAD_DTYPES:
            rows = enc.enc[i, : s.shape[0]]
            s = s.float() * rows[:, 0:1] + rows[:, 1:2]
        out[name] = s
    return Cloudsc2Inputs(**out)


def _prelude(enc: EncodedInputs, params: Params) -> KernelPrelude:
    ceta, zscalm = level_scalars(params, enc.ztrpaus)
    return KernelPrelude(ceta=ceta, zscalm=zscalm, ztrpaus=enc.ztrpaus,
                         paph_sfc=enc.paphsfc)


def _check_encoded(enc: EncodedInputs, what: str) -> torch.dtype:
    """The contract of the encoded TL/AD sweeps (``_EncGeometry``,
    ``experiments.py:515-536``): 16 streams, pq, plu and paph f32, every
    other one f32 or a 16-bit payload, one payload dtype per encoding.
    Returns the payload dtype (int16 where nothing is encoded)."""
    if len(enc.streams) != len(ENCODED_STREAMS):
        raise ValueError(f"{what} needs a fuse_satur=False encoding (pqs "
                         f"kept): {len(ENCODED_STREAMS)} streams, got "
                         f"{len(enc.streams)}")
    payloads = set()
    for name, s in zip(ENCODED_STREAMS, enc.streams):
        if s.dtype in PAYLOAD_DTYPES:
            payloads.add(s.dtype)
        elif s.dtype != torch.float32:
            raise TypeError(f"{what} is f32 only: {name} is {s.dtype}")
        if name in _KEEP_F32 and s.dtype != torch.float32:
            raise ValueError(f"{what} keeps {name} f32, got {s.dtype}")
    if len(payloads) > 1:
        raise TypeError(f"{what} takes one payload dtype per encoding, got "
                        f"int16 and bfloat16 streams")
    for name, x in (("enc", enc.enc), ("ztrpaus", enc.ztrpaus),
                    ("paphsfc", enc.paphsfc)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} is f32 only: {name} is {x.dtype}")
    return payloads.pop() if payloads else torch.int16


def _check_nl_encoded(enc: EncodedInputs, what: str):
    """The contract of the encoded NL sweep (``cloudsc2_pallas_encoded``):
    15 or 16 streams, each f32 or a 16-bit payload, one payload dtype for
    the encoding, everything else f32.  Returns the payload dtype (int16
    where nothing is encoded)."""
    if len(enc.streams) not in (len(ENCODED_STREAMS) - 1, len(ENCODED_STREAMS)):
        raise ValueError(f"{what} takes {len(ENCODED_STREAMS) - 1} streams "
                         f"(fuse_satur) or {len(ENCODED_STREAMS)}, got "
                         f"{len(enc.streams)}")
    payloads = set()
    for name, s in zip(enc.names, enc.streams):
        if s.dtype in PAYLOAD_DTYPES:
            payloads.add(s.dtype)
        elif s.dtype != torch.float32:
            raise TypeError(f"{what} is f32 only: {name} is {s.dtype}")
    if len(payloads) > 1:
        raise TypeError(f"{what} takes one payload dtype per encoding, got "
                        f"int16 and bfloat16 streams")
    for name, x in (("enc", enc.enc), ("ztrpaus", enc.ztrpaus),
                    ("paphsfc", enc.paphsfc)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} is f32 only: {name} is {x.dtype}")
    return payloads.pop() if payloads else torch.int16


# ------------------------------------------------------------ plain versions
def cloudsc2_nl_encoded_reference(
    enc: EncodedInputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """Plain encoded NL sweep on any device: decode, then the plain NL level
    loop on the decoded trajectory, with qsat SATUR of the decoded pt and
    pap for a ``fuse_satur`` encoding and the decoded pqs stream otherwise,
    and with the encoder's exact tropopause eta and surface pressure.
    Returns the 8 f32 output streams."""
    _check_nl_encoded(enc, "cloudsc2_nl_encoded")
    return _nl_sweep(decode_inputs(enc), params, ldrain1d,
                     pqs_stream=not enc.fuse_satur, checkpoints=False,
                     pre=_prelude(enc, params))[0]


def cloudsc2_tl_encoded_reference(
    enc: EncodedInputs, params: Params, *, dscale: float, lregcl: bool = True,
    ldrain1d: bool = False, write_primal: bool = True,
):
    """Plain encoded TL sweep on any device: decode, then
    :func:`~.tlad_kernel.cloudsc2_tl_reference` with ``dscale`` on the
    decoded trajectory, so the tangents are those of the quantised primal.
    Returns (outputs | None, tangents, checkpoints)."""
    _check_encoded(enc, "cloudsc2_tl_encoded")
    return tk.cloudsc2_tl_reference(
        decode_inputs(enc), params, dscale=dscale, lregcl=lregcl,
        ldrain1d=ldrain1d, write_primal=write_primal, pre=_prelude(enc, params))


def cloudsc2_ad_encoded_reference(
    enc: EncodedInputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
) -> Cloudsc2Inputs:
    """Plain encoded reverse sweep on any device: decode, then
    :func:`~.tlad_kernel.cloudsc2_ad_reference` on the decoded trajectory
    from the encoded TL sweep's checkpoints.  Returns the f32 input
    adjoints, levels-major."""
    _check_encoded(enc, "cloudsc2_ad_encoded")
    return tk.cloudsc2_ad_reference(
        decode_inputs(enc), d_outputs, checkpoints, params, lregcl=lregcl,
        ldrain1d=ldrain1d, fold_seeds=fold_seeds, pre=_prelude(enc, params))


def cloudsc2_tlad_fused_reference(
    inputs: Cloudsc2Inputs, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, dscale: float = 0.01,
):
    """Plain fused unit on any device: the plain TL sweep, then the plain
    reverse sweep seeded with its tangents (flux seeds folded), after one
    :func:`plain_prelude` for both.  Returns (outputs, tangents,
    input adjoints) like ``run_tlad(backend="streams")``."""
    tk._need_pqs(inputs)
    pre = plain_prelude(inputs, params)
    out, dout, ckpts = tk.cloudsc2_tl_reference(
        inputs, params, dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d, pre=pre)
    adj = tk.cloudsc2_ad_reference(inputs, dout, ckpts, params, lregcl=lregcl,
                                   ldrain1d=ldrain1d, fold_seeds=True, pre=pre)
    return out, dout, adj


def _need_pqs_stream(inputs: Cloudsc2Inputs) -> None:
    if inputs.pqs is None:
        raise ValueError("the resident sweep reads pqs as a stream: build the "
                         "inputs with device_kernel_inputs(..., pqs=True)")


def cloudsc2_nl_resident_reference(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """The plain PyTorch version of the resident sweep, on any device: the
    level loop of :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.
    cloudsc2_fwd_ckpt_reference` (``inputs.pqs`` read as it is), outputs
    only."""
    _need_pqs_stream(inputs)
    return _nl_sweep(inputs, params, ldrain1d, pqs_stream=True,
                     checkpoints=False)[0]


# -------------------------------------------------------------- CUDA kernels
# per library: the pointer arrays it takes, then its scalar arguments between
# the params array and the stream
_LAYOUT = {
    "cloudsc2_tl_enc": (
        (tk.TL_STREAMS, tk.TL_OUTPUTS),
        # level-major table, enc_mask; dscale; ncol nlev evap lregcl
        # write_primal
        [ctypes.c_void_p, ctypes.c_uint, ctypes.c_double] + [ctypes.c_int] * 5),
    "cloudsc2_ad_enc": (
        (tk.AD_STREAMS, tk.AD_OUTPUTS),
        # level-major table, enc_mask; seed scales; ncol nlev evap lregcl
        [ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_double] * 2
        + [ctypes.c_int] * 4),
    "cloudsc2_tlad_fused": (
        (tk.TL_STREAMS, FUSED_OUTPUTS),
        # scratch, tile counter, blocks; dscale, seed scales; ncol nlev evap
        # lregcl
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 3
        + [ctypes.c_int] * 4),
}


# the bfloat16 payloads' libraries take the int16 ones' arguments
_LAYOUT.update({f"{name}_bf16": _LAYOUT[name]
                for name in ("cloudsc2_tl_enc", "cloudsc2_ad_enc")})
# the encoded sweeps are built for f32 only; the fused kernel for both, with
# the query of its plan (fused_launch_plan: dtype, evap, lregcl, the plan)
_BINDINGS = {name: tk._binding(name, layout, ("f32",))
             for name, layout in _LAYOUT.items() if name != "cloudsc2_tlad_fused"}
_BINDINGS["cloudsc2_tlad_fused"] = tk._binding(
    "cloudsc2_tlad_fused", _LAYOUT["cloudsc2_tlad_fused"], queries={
        "cloudsc2_tlad_fused_plan": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]})


def _library(name: str):
    return build.bind(name, **_BINDINGS[name])


def _encoded_operands(enc: EncodedInputs, params: Params, ldrain1d: bool,
                      what: str, extra=None):
    """Check an encoding (and the ``extra`` f32 level streams by name) for a
    launch and return (operands by name, enc_mask, the suffix of the
    payload's library: "" for int16, "_bf16").  Every tensor lies contiguous
    on one CUDA device in the sweep's shape for it; a stream is a 16-bit
    payload or f32, everything else f32."""
    payload = _check_encoded(enc, what)
    like = enc.streams[ENCODED_STREAMS.index("pq")]
    if like.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {like.device}")
    tk._check_config(params, ldrain1d)
    operands = {**dict(zip(ENCODED_STREAMS, enc.streams)),
                **_prelude(enc, params)._asdict(), **(extra or {})}
    encoded = [n for n in ENCODED_STREAMS if operands[n].dtype in PAYLOAD_DTYPES]
    check_operands(operands, [n for n in operands if n not in encoded], like, what)
    nlev, ncol = like.shape
    if enc.levels is None:
        raise ValueError(f"{what} needs the encoding's level-major table "
                         f"(EncodedInputs.levels = level_major(enc.enc))")
    for name, x, shape in [(n, operands[n], (nlev, ncol)) for n in encoded] + [
            ("enc", enc.enc, (len(ENCODED_STREAMS), nlev + 1, 2)),
            ("levels", enc.levels, (nlev + 1, len(ENCODED_STREAMS), 2))]:
        if x.device != like.device or tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                             f"expected {shape} on {like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if enc.levels.dtype != torch.float32:
        raise TypeError(f"{what} is f32 only: levels is {enc.levels.dtype}")
    if enc.levels.data_ptr() % 16:
        raise ValueError(f"{what} reads levels as float4: it must be 16 B aligned")
    return operands, encoded_mask(enc), ("_bf16" if payload == torch.bfloat16 else "")


def encoded_mask(enc: EncodedInputs) -> int:
    """The launchers' ``enc_mask``: bit j set where stream j holds 16-bit
    payloads (the TL and AD sweeps' default encoding's is ``kDefaultMask``
    of ``csrc/cloudsc2_load.cuh``, the NL sweep's ``NL_DEFAULT_MASKS``; each
    has a kernel of its own)."""
    return sum(1 << j for j, s in enumerate(enc.streams)
               if s.dtype in PAYLOAD_DTYPES)


def nl_encoded_kernel(enc: EncodedInputs, kernel: Optional[str] = None) -> str:
    """Which encoded NL kernel runs ``enc``: ``"fixed"``, in which the mask
    is a compile-time constant, for the default encoding's mask of its
    stream order (``NL_DEFAULT_MASKS``), ``"runtime"`` for any other mask.
    ``kernel`` asks for one: ``"runtime"`` takes every mask, ``"fixed"``
    only its own, and anything else raises."""
    fixed = encoded_mask(enc) == NL_DEFAULT_MASKS[enc.fuse_satur]
    if kernel is None:
        return "fixed" if fixed else "runtime"
    if kernel == "runtime" or (kernel == "fixed" and fixed):
        return kernel
    raise ValueError(f"no encoded NL kernel {kernel!r} takes the mask "
                     f"{encoded_mask(enc):#x} (the fixed kernel takes "
                     f"{NL_DEFAULT_MASKS[enc.fuse_satur]:#x})")


def _bind_nl_encoded():
    n = len(ENCODED_STREAMS) + 4  # then ceta, zscalm, ztrpaus, paph_sfc
    return build.bind(
        "cloudsc2_nl_enc",
        {"cloudsc2_nl_enc_abi": (n - 1, n, len(KERNEL_OUTPUTS),
                                 len(KERNEL_CONSTANTS))},
        # in, out, consts; levels, enc_mask, fixed_mask, payload_bf16,
        # pqs_stream; ncol nlev evap; stream
        {"cloudsc2_nl_enc_f32": _NL_ARGTYPES[:3] + [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ] + _NL_ARGTYPES[3:]})


def launch_cloudsc2_nl_encoded(
    enc: EncodedInputs, params: Params, *, ldrain1d: bool = False,
    kernel: Optional[str] = None,
) -> Cloudsc2StreamOutputs:
    """Launch the encoded NL kernel on CUDA tensors, on the current stream:
    returns the 8 f32 output streams like the plain version.

    The kernel is :func:`nl_encoded_kernel`'s choice for the encoding's
    mask, or ``kernel`` where that kernel takes it.  Checks the encoding's
    contract, devices, dtypes, shapes and contiguity, allocates the
    outputs, and raises if the launch is refused.  Counts each launch in
    ``cloudsc2_nl_encoded.launches``."""
    what = "cloudsc2_nl_encoded"
    payload = _check_nl_encoded(enc, what)
    kernel = nl_encoded_kernel(enc, kernel)
    device = enc.paphsfc.device
    if device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {device}")
    _check_config(params, ldrain1d)
    names = enc.names
    if enc.streams[0].dim() != 2:
        raise ValueError(f"expected levels-major (nlev, ncol) streams, got "
                         f"{tuple(enc.streams[0].shape)}")
    nlev, ncol = enc.streams[0].shape
    pre = _prelude(enc, params)
    operands = {**dict(zip(names, enc.streams)), **pre._asdict()}
    shapes = {**{n: (nlev, ncol) for n in names}, "paph": (nlev + 1, ncol),
              "ceta": (nlev,), "zscalm": (nlev,), "ztrpaus": (ncol,),
              "paph_sfc": (ncol,), "enc": (len(names), nlev + 1, 2),
              "levels": (nlev + 1, TABLE_STREAMS, 2)}
    if enc.levels is None:
        raise ValueError(f"{what} needs the encoding's level-major table "
                         f"(EncodedInputs.levels = level_major(enc.enc))")
    for name, x in {**operands, "enc": enc.enc, "levels": enc.levels}.items():
        if x.device != device or tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                             f"expected {shapes[name]} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if enc.levels.dtype != torch.float32:
        raise TypeError(f"{what} is f32 only: levels is {enc.levels.dtype}")
    if enc.levels.data_ptr() % 16:
        raise ValueError(f"{what} reads levels as float4: it must be 16 B aligned")
    outs = [torch.empty((nlev, ncol), dtype=torch.float32, device=device)
            for _ in KERNEL_OUTPUTS]
    order = names + tuple(KernelPrelude._fields)
    consts = (ctypes.c_double * len(KERNEL_CONSTANTS))(
        *_kernel_constants(params, ldrain1d))
    build.launch(_bind_nl_encoded(), "cloudsc2_nl_enc", enc.paphsfc,
                 [operands[n] for n in order], outs, consts, enc.levels,
                 encoded_mask(enc), int(kernel == "fixed"),
                 int(payload == torch.bfloat16), int(not enc.fuse_satur), ncol, nlev,
                 int(_evap(params, ldrain1d)))
    cloudsc2_nl_encoded.launches += 1
    return Cloudsc2StreamOutputs(*outs)


def launch_cloudsc2_tl_encoded(
    enc: EncodedInputs, params: Params, *, dscale: float, lregcl: bool = True,
    ldrain1d: bool = False, write_primal: bool = True,
):
    """Launch the encoded TL kernel on CUDA tensors, on the current stream:
    returns (outputs | None, tangents, checkpoints), f32, like the plain
    version.

    Checks the encoding's contract, devices, dtypes, shapes and contiguity,
    allocates the outputs, and raises if the launch is refused.  Counts
    each launch in ``cloudsc2_tl_encoded.launches``, or, for a bfloat16
    payload (``csrc/cloudsc2_tl_enc_bf16.cu``), in
    ``cloudsc2_tl_encoded.launches_bf16``."""
    what = "cloudsc2_tl_encoded"
    operands, mask, suffix = _encoded_operands(enc, params, ldrain1d, what)
    like = operands["pq"]
    nlev, ncol = like.shape
    name = "cloudsc2_tl_enc" + suffix
    lib = _library(name)
    new = [torch.empty_like(like) for _ in range(8 + 3)]
    prim = [torch.empty_like(like) if write_primal else None for _ in range(8)]
    build.launch(lib, name, like, [operands[n] for n in tk.TL_STREAMS], new + prim,
                 tk._param_array(lib, name, params), enc.levels, mask, float(dscale),
                 ncol, nlev, int(_evap(params, ldrain1d)), int(lregcl),
                 int(write_primal))
    if suffix:
        cloudsc2_tl_encoded.launches_bf16 += 1
    else:
        cloudsc2_tl_encoded.launches += 1
    return (Cloudsc2StreamOutputs(*prim) if write_primal else None,
            Cloudsc2StreamOutputs(*new[:8]), tuple(new[8:]))


def launch_cloudsc2_ad_encoded(
    enc: EncodedInputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
) -> Cloudsc2Inputs:
    """Launch the encoded reverse-adjoint kernel on CUDA tensors, on the
    current stream: returns the f32 input adjoints like the plain version.

    Checks the encoding's contract, devices, dtypes, shapes and contiguity
    (checkpoints and seeds included), allocates the outputs, and raises if
    the launch is refused.  Counts each launch in
    ``cloudsc2_ad_encoded.launches``, or, for a bfloat16 payload
    (``csrc/cloudsc2_ad_enc_bf16.cu``), in
    ``cloudsc2_ad_encoded.launches_bf16``."""
    what = "cloudsc2_ad_encoded"
    extra = {**dict(zip(tk.CHECKPOINTS, checkpoints)),
             **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    operands, mask, suffix = _encoded_operands(enc, params, ldrain1d, what, extra)
    like = operands["pq"]
    nlev, ncol = like.shape
    name = "cloudsc2_ad_enc" + suffix
    lib = _library(name)
    outs = [torch.empty_like(like) for _ in _LEVEL_FIELDS] + [
        torch.empty_like(like), torch.empty_like(operands["paph"])]
    scales = tk.seed_scales(params) if fold_seeds else (1.0, 1.0)
    build.launch(lib, name, like, [operands[n] for n in tk.AD_STREAMS], outs,
                 tk._param_array(lib, name, params), enc.levels, mask, *scales,
                 ncol, nlev, int(_evap(params, ldrain1d)), int(lregcl))
    if suffix:
        cloudsc2_ad_encoded.launches_bf16 += 1
    else:
        cloudsc2_ad_encoded.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs))
    return Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d)


_PLAN_FIELDS = ("tl_groups", "ad_groups", "blocks_per_sm", "tl_registers",
                "ad_registers", "depth", "launch_registers", "shared_bytes",
                "kernel_registers")


def fused_launch_plan(inputs: Cloudsc2Inputs, params: Params, *,
                      lregcl: bool = True, ldrain1d: bool = False) -> dict:
    """How the fused kernel runs these inputs on their device, as the
    library was built (``kernels/fused_plan.py`` by default): warpgroups per
    block by role, blocks per SM, each role's register budget, ring depth,
    launch registers, the registers ptxas gave the kernel, shared bytes per
    block, SM count, warps per SM by role, the grid's blocks and the bytes
    of the checkpoint ring in device memory.  Raises where the roles'
    budgets do not fit the registers the kernel was given (the launch would
    be refused)."""
    lib = _library("cloudsc2_tlad_fused")
    dtype = "float64" if inputs.pt.dtype == torch.float64 else "float32"
    key = (dtype, bool(_evap(params, ldrain1d)), bool(lregcl))
    cache = lib.__dict__.setdefault("plans", {})
    if key not in cache:
        values = (ctypes.c_int * len(_PLAN_FIELDS))()
        build.launch(lib, "cloudsc2_tlad_fused_plan", inputs.pt.device,
                     int(dtype == "float64"), int(key[1]), int(key[2]), values,
                     stream=False)
        plan = dict(zip(_PLAN_FIELDS, values))
        split = fused_plan.Split(*(plan[f] for f in _PLAN_FIELDS[:6]))
        given = -(-plan["kernel_registers"] // 8) * 8
        if (split.tl_registers > given or split.ad_registers < given
                or split.role_registers > split.threads * given):
            raise RuntimeError(
                f"cloudsc2_tlad_fused {key}: ptxas gave the kernel "
                f"{plan['kernel_registers']} registers, which the roles' budgets "
                f"(TL {split.tl_registers}, AD {split.ad_registers}) do not fit")
        plan["warps_per_sm"] = split.warps_per_sm()
        cache[key] = (split, plan)
    split, plan = cache[key]
    nlev, ncol = inputs.pt.shape
    sms = torch.cuda.get_device_properties(inputs.pt.device).multi_processor_count
    blocks = split.blocks(ncol, sms)
    return {**plan, "sms": sms, "blocks": blocks,
            "scratch_bytes": split.scratch_bytes(blocks, nlev, dtype)}


def launch_cloudsc2_tlad_fused(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    lregcl: bool = True, ldrain1d: bool = False, dscale: float = 0.01,
):
    """Launch the fused TL+AD kernel on CUDA tensors, on the current stream:
    returns (outputs, tangents, input adjoints) like the plain version.

    Checks device, dtype, shape and contiguity, allocates the 32 outputs,
    the checkpoint ring and the tile counter from
    :func:`fused_launch_plan` (no ``(nlev, ncol)`` checkpoint tensor exists
    on this path; the launcher zeroes the counter on the stream), and raises
    if the launch is refused.  Counts each launch in
    ``cloudsc2_tlad_fused.launches``."""
    tk._check_launch(inputs, params, ldrain1d, "launch_cloudsc2_tlad_fused")
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, tk.TL_STREAMS, inputs.pt, "cloudsc2_tlad_fused")
    nlev, ncol = inputs.pt.shape
    lib = _library("cloudsc2_tlad_fused")
    plan = fused_launch_plan(inputs, params, lregcl=lregcl, ldrain1d=ldrain1d)
    scratch = inputs.pt.new_empty(plan["scratch_bytes"] // inputs.pt.element_size())
    next_tile = torch.empty(1, dtype=torch.int32, device=inputs.pt.device)
    outs = [torch.empty_like(inputs.pt) for _ in range(8 + 8 + len(_LEVEL_FIELDS))]
    outs += [torch.empty_like(inputs.plu), torch.empty_like(inputs.paph)]
    build.launch(lib, "cloudsc2_tlad_fused", inputs.pt,
                 [operands[n] for n in tk.TL_STREAMS], outs,
                 tk._param_array(lib, "cloudsc2_tlad_fused", params), scratch,
                 next_tile, plan["blocks"], float(dscale), *tk.seed_scales(params),
                 ncol, nlev, int(_evap(params, ldrain1d)), int(lregcl))
    cloudsc2_tlad_fused.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs[16:]))
    return (Cloudsc2StreamOutputs(*outs[:8]), Cloudsc2StreamOutputs(*outs[8:16]),
            Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d))


def _load_resident_kernel():
    argtypes = _NL_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return build.bind(
        "cloudsc2_nl_res",
        {"cloudsc2_nl_res_abi": (len(RESIDENT_STREAMS), len(KERNEL_OUTPUTS),
                                 len(KERNEL_CONSTANTS), _RESIDENT_STAGED,
                                 _RESIDENT_MAX_TILE)},
        {"cloudsc2_nl_res_f32": argtypes, "cloudsc2_nl_res_f64": argtypes,
         "cloudsc2_nl_res_max_ring_bytes": [ctypes.POINTER(ctypes.c_int)]})


def resident_ring(nlev: int, dtype: torch.dtype, tile=None, depth=None):
    """The resident sweep's block and ring for ``nlev`` levels of ``dtype``:
    ``(tile, depth, bytes)``.  ``tile`` columns to a block (default
    ``RESIDENT_TILE``), ``depth`` levels staged ahead, at most ``nlev``
    (default ``RESIDENT_DEPTH``); 16 streams of ``tile`` values per level."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tile = RESIDENT_TILE if tile is None else int(tile)
    if not 1 <= tile <= _RESIDENT_MAX_TILE:
        raise ValueError(f"tile must lie in 1..{_RESIDENT_MAX_TILE}, got {tile}")
    level_bytes = _RESIDENT_STAGED * itemsize * tile
    depth = RESIDENT_DEPTH if depth is None else int(depth)
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    depth = min(depth, nlev)
    return tile, depth, level_bytes * depth


def launch_cloudsc2_nl_resident(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    ldrain1d: bool = False, tile=None, depth=None,
) -> Cloudsc2StreamOutputs:
    """Launch the resident kernel on CUDA tensors, on the current stream.

    Checks device, dtype, shape and contiguity (pqs included), allocates the
    8 outputs, and raises, before launching, when the ring of
    :func:`resident_ring` exceeds the shared memory a block may have on the
    device, and after it if the launch is refused.  Counts each launch in
    ``cloudsc2_nl_resident.launches``."""
    _need_pqs_stream(inputs)
    if inputs.pt.device.type != "cuda":
        raise ValueError("launch_cloudsc2_nl_resident needs CUDA tensors, got "
                         f"{inputs.pt.device}")
    if inputs.pt.dim() != 2:
        raise ValueError("expected levels-major (nlev, ncol) inputs, got "
                         f"{tuple(inputs.pt.shape)}")
    tile, depth, ring = resident_ring(inputs.pt.shape[0], inputs.pt.dtype,
                                      tile, depth)
    lib = _load_resident_kernel()
    limit = ctypes.c_int()
    build.launch(lib, "cloudsc2_nl_res_max_ring_bytes", inputs.pt.device,
                 ctypes.byref(limit), stream=False)
    if ring > limit.value:
        raise ValueError(
            f"a ring of {depth} levels x {tile} columns of {inputs.pt.dtype} "
            f"takes {ring} bytes of shared memory; a block may have "
            f"{limit.value}: lower tile or depth")
    outs = _launch("cloudsc2_nl_res", RESIDENT_STREAMS, KERNEL_OUTPUTS,
                   inputs, pre, params, ldrain1d, library=lambda: lib,
                   extra=(tile, depth))
    cloudsc2_nl_resident.launches += 1
    return Cloudsc2StreamOutputs(*outs)


# ------------------------------------------------------------------ wrappers
def _enc_device(enc: EncodedInputs, what: str) -> str:
    kind = enc.paphsfc.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not "
                         f"{enc.paphsfc.device}")
    return kind


def cloudsc2_nl_encoded(
    enc: EncodedInputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """The NL sweep over 16-bit-encoded level streams, decoded in registers
    (``cloudsc2_pallas_encoded``, ``experiments.py:164``): returns the 8
    exact f32 output streams of the decoded trajectory.  ``LPHYLIN=False``
    without ``ldrain1d`` is refused, as there.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_nl_encoded`); CPU tensors run the plain version
    :func:`cloudsc2_nl_encoded_reference`; any other device raises."""
    if _enc_device(enc, "cloudsc2_nl_encoded") == "cpu":
        return cloudsc2_nl_encoded_reference(enc, params, ldrain1d=ldrain1d)
    return launch_cloudsc2_nl_encoded(enc, params, ldrain1d=ldrain1d)


def cloudsc2_tl_encoded(
    enc: EncodedInputs, params: Params, *, dscale: float, lregcl: bool = True,
    ldrain1d: bool = False, write_primal: bool = True,
):
    """The ``dscale`` TL sweep over 16-bit-encoded level streams, int16 or
    bfloat16 (``cloudsc2_pallas_tl_encoded``, ``experiments.py:603``):
    returns (outputs | None, tangents, checkpoints), f32.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_tl_encoded`); CPU tensors run the plain version
    :func:`cloudsc2_tl_encoded_reference`; any other device raises."""
    kw = dict(dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d,
              write_primal=write_primal)
    if _enc_device(enc, "cloudsc2_tl_encoded") == "cpu":
        return cloudsc2_tl_encoded_reference(enc, params, **kw)
    return launch_cloudsc2_tl_encoded(enc, params, **kw)


def cloudsc2_ad_encoded(
    enc: EncodedInputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
) -> Cloudsc2Inputs:
    """The reverse sweep over 16-bit-encoded level streams, int16 or
    bfloat16, from the encoded TL sweep's checkpoints
    (``cloudsc2_pallas_ad_encoded``,
    ``experiments.py:658``): returns the f32 input adjoints, levels-major.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_ad_encoded`); CPU tensors run the plain version
    :func:`cloudsc2_ad_encoded_reference`; any other device raises."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=fold_seeds)
    if _enc_device(enc, "cloudsc2_ad_encoded") == "cpu":
        return cloudsc2_ad_encoded_reference(enc, d_outputs, checkpoints,
                                             params, **kw)
    return launch_cloudsc2_ad_encoded(enc, d_outputs, checkpoints, params, **kw)


def cloudsc2_tlad_fused(
    inputs: Cloudsc2Inputs, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, dscale: float = 0.01,
):
    """The TL+AD work unit in one launch (``cloudsc2_pallas_tlad_fused``,
    ``experiments.py:398``): returns (outputs, tangents, input adjoints),
    the contract of ``run_tlad(backend="streams")``.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_tlad_fused`, after one :func:`kernel_prelude`);
    CPU tensors run the plain version :func:`cloudsc2_tlad_fused_reference`;
    any other device raises."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, dscale=dscale)
    if tk._device(inputs, "cloudsc2_tlad_fused") == "cpu":
        return cloudsc2_tlad_fused_reference(inputs, params, **kw)
    return launch_cloudsc2_tlad_fused(inputs, kernel_prelude(inputs, params),
                                      params, **kw)


def cloudsc2_nl_resident(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
    tile=None, depth=None,
) -> Cloudsc2StreamOutputs:
    """The NL sweep with pqs streamed and the inputs staged through shared
    memory (``cloudsc2_pallas(mode="resident")``), on levels-major inputs
    with pqs.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_nl_resident`, after :func:`kernel_prelude`) with
    blocks of ``tile`` columns and ``depth`` levels in flight
    (:func:`resident_ring`; ``depth >= nlev`` holds every level on chip before
    the first is computed); CPU tensors run the plain version
    :func:`cloudsc2_nl_resident_reference`, which has no ring; any other
    device raises."""
    _need_pqs_stream(inputs)
    device = inputs.pt.device
    if device.type == "cpu":
        resident_ring(inputs.pt.shape[0], inputs.pt.dtype, tile, depth)
        return cloudsc2_nl_resident_reference(inputs, params, ldrain1d=ldrain1d)
    if device.type != "cuda":
        raise ValueError(f"cloudsc2_nl_resident runs on cuda or cpu tensors, not {device}")
    return launch_cloudsc2_nl_resident(
        inputs, kernel_prelude(inputs, params), params, ldrain1d=ldrain1d,
        tile=tile, depth=depth)


cloudsc2_nl_encoded.launches = 0
cloudsc2_nl_resident.launches = 0
cloudsc2_tl_encoded.launches = cloudsc2_tl_encoded.launches_bf16 = 0
cloudsc2_ad_encoded.launches = cloudsc2_ad_encoded.launches_bf16 = 0
cloudsc2_tlad_fused.launches = 0
