"""The scheduling experiments over 16-bit-encoded streams and the fused
unit: the stream encoder, the encoded NL, TL and AD sweeps, and the
single-launch fused TL+AD unit.

Port of :mod:`cloudsc2jax.pallas.experiments`.  None of these is on a
production path; :mod:`cloudsc2jax_torch.kernel_ab` runs the TL+AD ones
beside the two-kernel unit (:func:`~cloudsc2jax_torch.drivers.run_tlad`) on
one set of inputs and prints one timing line per schedule, and
``chip_smoke.py`` times the encoded NL sweep beside the exact one.

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
  and level.
* :func:`decode_inputs` and the plain versions
  :func:`cloudsc2_nl_encoded_reference` (decode, then the plain NL sweep,
  with SATUR or the decoded pqs stream as the encoding has it),
  :func:`cloudsc2_tl_encoded_reference`, :func:`cloudsc2_ad_encoded_reference`
  (decode, then the plain TL / AD sweep), each on the decoded trajectory with
  the encoder's exact tropopause eta and surface pressure, and
  :func:`cloudsc2_tlad_fused_reference` (the plain TL then the plain AD with
  folded seeds, after one :func:`kernel_prelude`).
* :func:`cloudsc2_nl_encoded`, :func:`cloudsc2_tl_encoded`,
  :func:`cloudsc2_ad_encoded` and :func:`cloudsc2_tlad_fused` are the
  wrappers.  CUDA tensors go to the hand-written kernels
  (``csrc/cloudsc2_nl_enc.cu``, ``csrc/cloudsc2_tl_enc.cu``,
  ``csrc/cloudsc2_ad_enc.cu``, ``csrc/cloudsc2_tlad_fused.cu``), CPU tensors
  to the plain versions, any other device raises.  Each counts its kernel
  launches in ``.launches``.

The encoded sweeps are f32 only.  The NL sweep takes any subset of its
streams encoded, plu and paph included, either payload, and both
``fuse_satur`` settings (``cloudsc2_pallas_encoded``,
``experiments.py:164``).  The TL and AD sweeps keep ``pq``, ``plu`` and
``paph`` as f32 streams and take int16 payloads only, as in the JAX package
(``_EncGeometry``, ``experiments.py:519-533``); the fused unit runs in float
and double.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs
from . import tlad_kernel as tk
from .cloudsc2_kernel import (
    KERNEL_CONSTANTS,
    KERNEL_OUTPUTS,
    Checkpoints,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _NL_ARGTYPES,
    _check_config,
    _evap,
    _kernel_constants,
    _nl_sweep,
    bind_library,
    check_operands,
    kernel_prelude,
    level_scalars,
)

__all__ = [
    "ENCODED_STREAMS",
    "FUSED_OUTPUTS",
    "EncodedInputs",
    "cloudsc2_ad_encoded",
    "cloudsc2_ad_encoded_reference",
    "cloudsc2_nl_encoded",
    "cloudsc2_nl_encoded_reference",
    "cloudsc2_tl_encoded",
    "cloudsc2_tl_encoded_reference",
    "cloudsc2_tlad_fused",
    "cloudsc2_tlad_fused_reference",
    "decode_inputs",
    "encode_blocked_inputs",
    "fused_slots",
    "launch_cloudsc2_ad_encoded",
    "launch_cloudsc2_nl_encoded",
    "launch_cloudsc2_tl_encoded",
    "launch_cloudsc2_tlad_fused",
]

# the 16 streams of a `fuse_satur=False` encoding, in the kernels' pointer
# order (the first 16 of TL_STREAMS)
ENCODED_STREAMS = _LEVEL_FIELDS + ("plu", "paph")
_KEEP_F32 = ("pq", "plu", "paph")
PAYLOAD_DTYPES = (torch.int16, torch.bfloat16)
# pointer order of the fused launcher's outputs (enum Output in
# csrc/cloudsc2_tlad_fused.cu)
FUSED_OUTPUTS = (KERNEL_OUTPUTS + tuple("d_" + n for n in KERNEL_OUTPUTS)
                 + tk.AD_OUTPUTS)


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
    the per-column f32 operands, computed before quantisation.
    """

    streams: Tuple[torch.Tensor, ...]
    enc: torch.Tensor
    ztrpaus: torch.Tensor
    paphsfc: torch.Tensor

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
                         ztrpaus=pre.ztrpaus, paphsfc=pre.paph_sfc.contiguous())


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


def _check_encoded(enc: EncodedInputs, what: str) -> None:
    """The contract of the encoded TL/AD sweeps (``_EncGeometry``,
    ``experiments.py:519-533``)."""
    if len(enc.streams) != len(ENCODED_STREAMS):
        raise ValueError(f"{what} needs a fuse_satur=False encoding (pqs "
                         f"kept): {len(ENCODED_STREAMS)} streams, got "
                         f"{len(enc.streams)}")
    for name, s in zip(ENCODED_STREAMS, enc.streams):
        if s.dtype == torch.bfloat16:
            raise TypeError(f"{what} takes int16 payloads only: {name} is "
                            f"bfloat16, the encoded NL sweep's payload")
        if s.dtype not in (torch.int16, torch.float32):
            raise TypeError(f"{what} is f32 only: {name} is {s.dtype}")
        if name in _KEEP_F32 and s.dtype != torch.float32:
            raise ValueError(f"{what} keeps {name} f32, got {s.dtype}")
    for name, x in (("enc", enc.enc), ("ztrpaus", enc.ztrpaus),
                    ("paphsfc", enc.paphsfc)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} is f32 only: {name} is {x.dtype}")


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
    :func:`kernel_prelude` for both.  Returns (outputs, tangents,
    input adjoints) like ``run_tlad(backend="streams")``."""
    tk._need_pqs(inputs)
    pre = kernel_prelude(inputs, params)
    out, dout, ckpts = tk.cloudsc2_tl_reference(
        inputs, params, dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d, pre=pre)
    adj = tk.cloudsc2_ad_reference(inputs, dout, ckpts, params, lregcl=lregcl,
                                   ldrain1d=ldrain1d, fold_seeds=True, pre=pre)
    return out, dout, adj


# -------------------------------------------------------------- CUDA kernels
# per library: the pointer arrays it takes, then its scalar arguments between
# the params array and the stream
_LAYOUT = {
    "cloudsc2_tl_enc": (
        (tk.TL_STREAMS, tk.TL_OUTPUTS),
        # table, enc_mask; dscale; ncol nlev evap lregcl write_primal
        [ctypes.c_void_p, ctypes.c_uint, ctypes.c_double] + [ctypes.c_int] * 5),
    "cloudsc2_ad_enc": (
        (tk.AD_STREAMS, tk.AD_OUTPUTS),
        # table, enc_mask; seed scales; ncol nlev evap lregcl
        [ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_double] * 2
        + [ctypes.c_int] * 4),
    "cloudsc2_tlad_fused": (
        (tk.TL_STREAMS, FUSED_OUTPUTS),
        # scratch, slots; dscale, seed scales; ncol nlev evap lregcl
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 3
        + [ctypes.c_int] * 4),
}


def _bind(name: str):
    return tk._bind(name, _LAYOUT[name],
                    ("f32", "f64") if name == "cloudsc2_tlad_fused" else ("f32",))


def _encoded_operands(enc: EncodedInputs, params: Params, ldrain1d: bool,
                      what: str, extra=None):
    """Check an encoding (and the ``extra`` f32 level streams by name) for a
    launch and return (operands by name, enc_mask).  Every tensor lies
    contiguous on one CUDA device in the sweep's shape for it; a stream is
    int16 or f32, everything else f32."""
    _check_encoded(enc, what)
    like = enc.streams[ENCODED_STREAMS.index("pq")]
    if like.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {like.device}")
    tk._check_config(params, ldrain1d)
    operands = {**dict(zip(ENCODED_STREAMS, enc.streams)),
                **_prelude(enc, params)._asdict(), **(extra or {})}
    encoded = [n for n in ENCODED_STREAMS if operands[n].dtype == torch.int16]
    check_operands(operands, [n for n in operands if n not in encoded], like, what)
    nlev, ncol = like.shape
    for name, x, shape in [(n, operands[n], (nlev, ncol)) for n in encoded] + [
            ("enc", enc.enc, (len(ENCODED_STREAMS), nlev + 1, 2))]:
        if x.device != like.device or tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                             f"expected {shape} on {like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    mask = sum(1 << ENCODED_STREAMS.index(n) for n in encoded)
    return operands, mask


def _bind_nl_encoded():
    n = len(ENCODED_STREAMS) + 4  # then ceta, zscalm, ztrpaus, paph_sfc
    return bind_library(
        "cloudsc2_nl_enc",
        {"cloudsc2_nl_enc_abi": (n - 1, n, len(KERNEL_OUTPUTS),
                                 len(KERNEL_CONSTANTS))},
        # in, out, consts; table, enc_mask, payload_bf16, pqs_stream; ncol
        # nlev evap; stream
        {"cloudsc2_nl_enc_f32": _NL_ARGTYPES[:3] + [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ] + _NL_ARGTYPES[3:]})


def launch_cloudsc2_nl_encoded(
    enc: EncodedInputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """Launch the encoded NL kernel on CUDA tensors, on the current stream:
    returns the 8 f32 output streams like the plain version.

    Checks the encoding's contract, devices, dtypes, shapes and contiguity,
    allocates the outputs, and raises if the launch is refused.  Counts
    each launch in ``cloudsc2_nl_encoded.launches``."""
    what = "cloudsc2_nl_encoded"
    payload = _check_nl_encoded(enc, what)
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
              "paph_sfc": (ncol,), "enc": (len(names), nlev + 1, 2)}
    for name, x in {**operands, "enc": enc.enc}.items():
        if x.device != device or tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                             f"expected {shapes[name]} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    mask = sum(1 << j for j, s in enumerate(enc.streams)
               if s.dtype in PAYLOAD_DTYPES)
    lib = _bind_nl_encoded()
    outs = [torch.empty((nlev, ncol), dtype=torch.float32, device=device)
            for _ in KERNEL_OUTPUTS]
    order = names + tuple(KernelPrelude._fields)
    in_ptrs = (ctypes.c_void_p * len(order))(
        *(operands[n].data_ptr() for n in order))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    consts = (ctypes.c_double * len(KERNEL_CONSTANTS))(
        *_kernel_constants(params, ldrain1d))
    with torch.cuda.device(device):
        err = lib.cloudsc2_nl_enc_f32(
            in_ptrs, out_ptrs, consts, enc.enc.data_ptr(), mask,
            int(payload == torch.bfloat16), int(not enc.fuse_satur), ncol,
            nlev, int(_evap(params, ldrain1d)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
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
    each launch in ``cloudsc2_tl_encoded.launches``."""
    what = "cloudsc2_tl_encoded"
    operands, mask = _encoded_operands(enc, params, ldrain1d, what)
    like = operands["pq"]
    nlev, ncol = like.shape
    lib = _bind("cloudsc2_tl_enc")
    new = [torch.empty_like(like) for _ in range(8 + 3)]
    prim = [torch.empty_like(like) if write_primal else None for _ in range(8)]
    tk._call(lib, "cloudsc2_tl_enc", like,
             ([operands[n] for n in tk.TL_STREAMS], new + prim),
             tk._param_array(lib, params), enc.enc.data_ptr(), mask,
             float(dscale), ncol, nlev, int(_evap(params, ldrain1d)),
             int(lregcl), int(write_primal))
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
    ``cloudsc2_ad_encoded.launches``."""
    what = "cloudsc2_ad_encoded"
    extra = {**dict(zip(tk.CHECKPOINTS, checkpoints)),
             **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    operands, mask = _encoded_operands(enc, params, ldrain1d, what, extra)
    like = operands["pq"]
    nlev, ncol = like.shape
    lib = _bind("cloudsc2_ad_enc")
    outs = [torch.empty_like(like) for _ in _LEVEL_FIELDS] + [
        torch.empty_like(like), torch.empty_like(operands["paph"])]
    scales = tk.seed_scales(params) if fold_seeds else (1.0, 1.0)
    tk._call(lib, "cloudsc2_ad_enc", like,
             ([operands[n] for n in tk.AD_STREAMS], outs),
             tk._param_array(lib, params), enc.enc.data_ptr(), mask, *scales,
             ncol, nlev, int(_evap(params, ldrain1d)), int(lregcl))
    cloudsc2_ad_encoded.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs))
    return Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d)


def fused_slots(inputs: Cloudsc2Inputs, params: Params, *, lregcl: bool = True,
                ldrain1d: bool = False) -> int:
    """Threads of the fused kernel's persistent grid for these inputs on
    their device: block size x min(SMs x blocks per SM, blocks the columns
    need), with the blocks per SM the occupancy calculator says one SM
    holds of this kernel variant."""
    lib = _bind("cloudsc2_tlad_fused")
    fn = lib.cloudsc2_tlad_fused_resident
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    threads, blocks, sms = (ctypes.c_int() for _ in range(3))
    with torch.cuda.device(inputs.pt.device):
        err = fn(int(inputs.pt.dtype == torch.float64),
                 int(_evap(params, ldrain1d)), int(lregcl), ctypes.byref(threads),
                 ctypes.byref(blocks), ctypes.byref(sms))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"cloudsc2_tlad_fused occupancy query failed: "
                           f"cudaError_t {err}, {blocks.value} blocks per SM")
    needed = -(-inputs.pt.shape[1] // threads.value)
    return threads.value * min(sms.value * blocks.value, needed)


def launch_cloudsc2_tlad_fused(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    lregcl: bool = True, ldrain1d: bool = False, dscale: float = 0.01,
):
    """Launch the fused TL+AD kernel on CUDA tensors, on the current stream:
    returns (outputs, tangents, input adjoints) like the plain version.

    Checks device, dtype, shape and contiguity, allocates the 32 outputs
    and the checkpoint scratch ``(3, nlev, slots)`` with ``slots`` from
    :func:`fused_slots` (no ``(nlev, ncol)`` checkpoint tensor exists on
    this path), and raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tlad_fused.launches``."""
    tk._check_launch(inputs, params, ldrain1d, "launch_cloudsc2_tlad_fused")
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, tk.TL_STREAMS, inputs.pt, "cloudsc2_tlad_fused")
    nlev, ncol = inputs.pt.shape
    lib = _bind("cloudsc2_tlad_fused")
    slots = fused_slots(inputs, params, lregcl=lregcl, ldrain1d=ldrain1d)
    scratch = inputs.pt.new_empty((3, nlev, slots))
    outs = [torch.empty_like(inputs.pt) for _ in range(8 + 8 + len(_LEVEL_FIELDS))]
    outs += [torch.empty_like(inputs.plu), torch.empty_like(inputs.paph)]
    tk._call(lib, "cloudsc2_tlad_fused", inputs.pt,
             ([operands[n] for n in tk.TL_STREAMS], outs),
             tk._param_array(lib, params), scratch.data_ptr(), slots,
             float(dscale), *tk.seed_scales(params), ncol, nlev,
             int(_evap(params, ldrain1d)), int(lregcl))
    cloudsc2_tlad_fused.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs[16:]))
    return (Cloudsc2StreamOutputs(*outs[:8]), Cloudsc2StreamOutputs(*outs[8:16]),
            Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d))


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
    """The ``dscale`` TL sweep over int16-encoded level streams
    (``cloudsc2_pallas_tl_encoded``, ``experiments.py:603``): returns
    (outputs | None, tangents, checkpoints), f32.

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
    """The reverse sweep over int16-encoded level streams, from the encoded
    TL sweep's checkpoints (``cloudsc2_pallas_ad_encoded``,
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


cloudsc2_nl_encoded.launches = 0
cloudsc2_tl_encoded.launches = 0
cloudsc2_ad_encoded.launches = 0
cloudsc2_tlad_fused.launches = 0
