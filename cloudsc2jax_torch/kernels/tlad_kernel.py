"""The tangent-linear and reverse-adjoint sweeps: CUDA kernels and plain
versions.

Port of :mod:`cloudsc2jax.pallas.tlad_kernel`, on two contracts.

The stream contract (JAX ``blocked=True``), the TL+AD work unit:
``cloudsc2_pallas_tl(dscale=0.01, save_checkpoints=True, write_primal=…)``
(``_tl_kernel``) followed by ``cloudsc2_pallas_ad(checkpoints=…,
fold_seeds=True)`` (``_rev_kernel``, in-place scatter).  Streams are
levels-major ``(nlev, ncol)`` (paph ``(nlev+1, ncol)``) with no column
padding, and the TL/AD level sweeps read ``inputs.pqs`` as an independent
input (``Cloudsc2State.device_kernel_inputs(..., pqs=True)``).

* :func:`cloudsc2_tl` and :func:`cloudsc2_ad` are the wrappers.  A CUDA
  tensor goes to the hand-written kernel (``csrc/cloudsc2_tl.cu``,
  ``csrc/cloudsc2_ad.cu``), a CPU tensor to the plain version, any other
  device raises.  Each counts its kernel launches in ``.launches``, and
  while ``torch.profiler`` records gives its span the counters of the
  kernel instance it launched (:func:`occupancy`).
* :func:`cloudsc2_tl_din` is the TL sweep with STREAMED increments
  (``_tl_kernel`` without ``dscale``): its kernel
  (``csrc/cloudsc2_tl_din.cu``) reads a second set of 16 streams and
  writes no checkpoints.
* The schedules JAX keeps beside those: ``chunk_levels`` C in
  :data:`CHUNK_LEVELS` (C levels a step, ``_tl_kernel``/``_rev_kernel``
  with ``chunk``; ``csrc/cloudsc2_tl_chunk.cu``,
  ``csrc/cloudsc2_tl_din_chunk.cu``, ``csrc/cloudsc2_ad_chunk.cu``, and the
  forward-checkpoint sweep's ``csrc/cloudsc2_fwd_chunk.cu``), and the
  17-stream adjoint convention (``cloudsc2_ad(inplace_scatter=False)``,
  ``csrc/cloudsc2_ad_xscat.cu``): the reverse sweep writes the cotangents
  of all 17 values a level reads at that level's slot
  (:class:`ShiftedAdjoints`) and :func:`assemble_shifted_adjoints` adds the
  shifted ones in PyTorch.  Each counts its launches beside the kernel of
  its wrapper (``cloudsc2_tl.launches_chunked``, ``cloudsc2_ad.launches_xscat``,
  ...).  The results do not depend on the schedule: every level runs the
  same body on the same values in the same order.
* :func:`cloudsc2_tl_reference` and :func:`cloudsc2_ad_reference` are the
  plain versions: a Python loop over levels of ``torch.func.jvp`` of
  :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.level_physics`, and a
  reversed loop of ``torch.func.vjp`` from the carry checkpoints.
* The kernels' level bodies are generated from the same ``level_physics``
  by :mod:`cloudsc2jax_torch.kernels.emit`, for ``lregcl`` off and on.

The standard contract (JAX's default), the standalone TL and AD:
:func:`cloudsc2_kernel_tl` and :func:`cloudsc2_kernel_ad` are drop-ins for
:func:`cloudsc2jax_torch.tlad.cloudsc2_tl` / ``cloudsc2_ad`` as
``cloudsc2_pallas_tl(inputs, d_inputs, …)`` / ``cloudsc2_pallas_ad(inputs,
d_outputs, …)`` are in JAX: ``(ncol, nlev)`` in, the 10-field
:class:`Cloudsc2Outputs` and the 16-field adjoints out.  The adjoint runs
its own forward sweep
(:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.cloudsc2_fwd_ckpt`) and
seeds the reverse sweep through :func:`seed_streams`.  The transposes to
and from levels-major are PyTorch passes outside the kernels;
``levels_major=True`` skips them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import spans
from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from .cloudsc2_kernel import (
    CHECKPOINTS,
    CHUNK_LEVELS,
    KERNEL_OUTPUTS,
    Checkpoints,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _check_config,
    _evap,
    check_chunk_levels,
    check_operands,
    cloudsc2_fwd_ckpt_reference,
    kernel_prelude,
    plain_prelude,
    launch_cloudsc2_fwd_ckpt,
    level_physics,
    unblock_outputs,
)

__all__ = [
    "AD_OUTPUTS",
    "AD_SHIFTED_OUTPUTS",
    "AD_STREAMS",
    "CHUNK_LEVELS",
    "ShiftedAdjoints",
    "TL_OUTPUTS",
    "TL_STREAMS",
    "TL_TANGENT_STREAMS",
    "assemble_shifted_adjoints",
    "check_chunk_levels",
    "cloudsc2_ad",
    "cloudsc2_ad_reference",
    "cloudsc2_ad_streams_reference",
    "cloudsc2_kernel_ad",
    "cloudsc2_kernel_tl",
    "cloudsc2_tl",
    "cloudsc2_tl_din",
    "cloudsc2_tl_reference",
    "fold_flux_seeds",
    "launch_cloudsc2_ad",
    "launch_cloudsc2_ad_streams",
    "launch_cloudsc2_tl",
    "launch_cloudsc2_tl_din",
    "occupancy",
    "seed_scales",
    "seed_streams",
    "to_levels_major",
]

# Argument arrays of the C launchers; names and order are those of the enums
# in csrc/cloudsc2_tl_sweep.cuh and csrc/cloudsc2_ad_sweep.cuh.
_COMMON = ("plu", "paph", "ceta", "zscalm", "ztrpaus", "paph_sfc")
TL_STREAMS = _LEVEL_FIELDS + _COMMON
TL_TANGENT_STREAMS = _LEVEL_FIELDS + ("plu", "paph")
TL_OUTPUTS = tuple("d_" + n for n in KERNEL_OUTPUTS) + CHECKPOINTS + KERNEL_OUTPUTS
AD_STREAMS = _LEVEL_FIELDS + _COMMON + CHECKPOINTS + tuple("seed_" + n for n in KERNEL_OUTPUTS)
AD_OUTPUTS = tuple("d_" + n for n in _LEVEL_FIELDS) + ("d_plu", "d_paph")
# the 17-stream convention's outputs (ShiftedOutput in the AD header): the
# cotangents of a level's 17 reads at its own slot, then the surface row
AD_SHIFTED_OUTPUTS = tuple("d_" + n for n in _LEVEL_FIELDS) + (
    "d_plu_k1", "d_paph_lo", "d_paph_hi", "d_paph_sfc")


ShiftedAdjoints = NamedTuple("ShiftedAdjoints", [
    (n.removeprefix("d_"), torch.Tensor) for n in AD_SHIFTED_OUTPUTS])
ShiftedAdjoints.__doc__ = """The reverse sweep's results under the 17-stream
convention (``_rev_kernel``, ``tlad_kernel.py:564-610``), levels-major: the
adjoints of the 14 level rows, then the cotangents of each level's plu(k+1),
paph(k) and paph(k+1) reads at the level's own slot, each ``(nlev, ncol)``,
and the sum over levels of the paph_sfc cotangent, ``(ncol,)``; the
kernels' outputs in their order (:data:`AD_SHIFTED_OUTPUTS`).
:func:`assemble_shifted_adjoints` makes d_plu and d_paph of them."""


def seed_scales(params: Params) -> Tuple[float, float]:
    """(1 + rlvtt², 1 + rlstt²), folded in double: the flux-seed factors."""
    cst = params.yomcst
    return 1.0 + float(cst.rlvtt) ** 2, 1.0 + float(cst.rlstt) ** 2


def fold_flux_seeds(d_out: Cloudsc2StreamOutputs, params: Params) -> Cloudsc2StreamOutputs:
    """Fold the 10-field output cotangent into the 8 seed streams.

    The contract exposes the rain and snow fluxes twice, as PFPLSL/N and
    as the enthalpy fluxes PFHPSL/N = -RLVTT/RLSTT × flux
    (cloudsc2.F90:730-735), so seeding the adjoint with the TL image on
    those 10 fields scales the flux streams by (1 + L²)
    (cloudsc_driver_ad_mod.F90:216-237).  The AD kernel and its plain
    version apply the same fold to each level's seeds as they load them.
    """
    srfl, ssfl = seed_scales(params)
    return d_out._replace(rfln=d_out.rfln * srfl, sfln=d_out.sfln * ssfl)


def _level_fields(inputs: Cloudsc2Inputs, k: int, nlev: int):
    """The 17 values of level ``k``: 14 level rows, plu(k+1) clamped at the
    last level, paph(k), paph(k+1)."""
    return tuple(getattr(inputs, n)[k] for n in _LEVEL_FIELDS) + (
        inputs.plu[min(k + 1, nlev - 1)], inputs.paph[k], inputs.paph[k + 1],
    )


def _level_fn(params: Params, ldrain1d: bool, lregcl: bool, pre: KernelPrelude,
              k: int, nlev: int):
    scalars = (pre.ceta[k], pre.zscalm[k], k < nlev - 1)
    return lambda fl, co, ca: level_physics(params, ldrain1d, scalars, fl, co,
                                            ca, lregcl=lregcl)


def _need_pqs(inputs: Cloudsc2Inputs) -> None:
    if inputs.pqs is None:
        raise ValueError("the TL/AD sweeps read pqs: build the inputs with "
                         "device_kernel_inputs(..., pqs=True)")


def _inplace(inplace_scatter: Optional[bool], chunk_levels: int) -> bool:
    """``inplace_scatter`` resolved as ``cloudsc2_pallas_ad`` resolves it
    (``tlad_kernel.py:662-668``): on by default for one level a step, and
    refused with more."""
    if inplace_scatter is None:
        return chunk_levels == 1
    if inplace_scatter and chunk_levels != 1:
        raise ValueError("inplace_scatter requires chunk_levels == 1 (the "
                         "17-stream convention is the chunked sweeps' only one)")
    return bool(inplace_scatter)


def _check_primal(write_primal: bool, chunk_levels: int) -> None:
    if not write_primal and chunk_levels != 1:
        raise ValueError("write_primal=False requires chunk_levels == 1, as in "
                         "cloudsc2_pallas_tl")


@spans.spanned("contract")
def assemble_shifted_adjoints(d_plu_k1: torch.Tensor, d_paph_lo: torch.Tensor,
                              d_paph_hi: torch.Tensor, dpaphsfc: torch.Tensor):
    """``(d_plu, d_paph)`` from the 17-stream convention's shifted
    cotangents, as ``cloudsc2_pallas_ad`` assembles them
    (``tlad_kernel.py:790-803``): plu(k+1) read at level k gives ``d_plu[k+1]``
    (level 0 is never read as k+1; the clamped last-level read has a zero
    cotangent and is dropped); paph is read as lo(k) and hi(k+1), so ``d_paph
    = [lo; 0] + [0; hi]``; the surface row adds ``dpaphsfc`` last."""
    zrow = d_plu_k1.new_zeros((1, d_plu_k1.shape[1]))
    d_plu = torch.cat([zrow, d_plu_k1[:-1]])
    d_paph = torch.cat([d_paph_lo, zrow]) + torch.cat([zrow, d_paph_hi])
    d_paph[-1] = d_paph[-1] + dpaphsfc
    return d_plu, d_paph


def _assembled(streams: ShiftedAdjoints) -> Cloudsc2Inputs:
    d_plu, d_paph = assemble_shifted_adjoints(*streams[len(_LEVEL_FIELDS):])
    return Cloudsc2Inputs(plu=d_plu, paph=d_paph,
                          **dict(zip(_LEVEL_FIELDS, streams)))


# ------------------------------------------------------------ plain versions
def _one_increment(dscale, d_inputs) -> None:
    if (d_inputs is None) == (dscale is None):
        raise ValueError("provide exactly one of d_inputs or dscale")


@spans.spanned("tl_sweep")
def cloudsc2_tl_reference(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: Optional[float] = None,
    d_inputs: Optional[Cloudsc2Inputs] = None,
    lregcl: bool = True, ldrain1d: bool = False, write_primal: bool = True,
    pre: Optional[KernelPrelude] = None, chunk_levels: int = 1,
) -> Tuple[Optional[Cloudsc2StreamOutputs], Cloudsc2StreamOutputs, Checkpoints]:
    """Plain TL sweep on any device: returns (outputs | None, tangents,
    checkpoints).

    Exactly one of ``dscale`` and ``d_inputs`` gives the increments
    (``tlad_kernel.py:323``): ``dscale·x`` of every level value and of
    paph_sfc, or the levels-major ``d_inputs`` read like the inputs
    (``d_plu`` at k+1 clamped, ``d_paph`` at k and k+1, its last row the
    paph_sfc tangent).  The tropopause eta has a zero tangent
    (``tlad_kernel.py:238-245``).  ``checkpoints`` are the 3 carries (rfl,
    sfl, covptot) going INTO each level, ``(nlev, ncol)`` each.  ``pre``
    replaces :func:`plain_prelude` of ``inputs`` where the caller has it.
    ``chunk_levels`` is checked as the kernels check it (with more than one
    level a step the primal streams are written) and runs the same loop: the
    results do not depend on it.
    """
    _one_increment(dscale, d_inputs)
    _check_primal(write_primal, check_chunk_levels(chunk_levels))
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = plain_prelude(inputs, params) if pre is None else pre
    nlev = inputs.pt.shape[0]
    zero = torch.zeros_like(inputs.pt[0])
    carry = dcarry = (zero, zero, zero)
    cols = (pre.ztrpaus, pre.paph_sfc)
    dcols = (torch.zeros_like(pre.ztrpaus),
             dscale * pre.paph_sfc if d_inputs is None else d_inputs.paph[nlev])
    outs = ([torch.empty_like(inputs.pt) for _ in KERNEL_OUTPUTS]
            if write_primal else None)
    douts = [torch.empty_like(inputs.pt) for _ in KERNEL_OUTPUTS]
    ckpts = tuple(torch.empty_like(inputs.pt) for _ in range(3))
    for k in range(nlev):
        fields = _level_fields(inputs, k, nlev)
        for buf, v in zip(ckpts, carry):
            buf[k] = v
        (out, newc), (dout, dnewc) = torch.func.jvp(
            _level_fn(params, ldrain1d, lregcl, pre, k, nlev),
            (fields, cols, carry),
            (tuple(dscale * x for x in fields) if d_inputs is None
             else _level_fields(d_inputs, k, nlev), dcols, dcarry),
        )
        if outs is not None:
            for buf, v in zip(outs, out):
                buf[k] = v
        for buf, v in zip(douts, dout):
            buf[k] = v
        carry, dcarry = newc, dnewc
    return (None if outs is None else Cloudsc2StreamOutputs(*outs),
            Cloudsc2StreamOutputs(*douts), ckpts)


@spans.spanned("ad_sweep")
def cloudsc2_ad_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
    inplace_scatter: Optional[bool] = None, chunk_levels: int = 1,
) -> Cloudsc2Inputs:
    """Plain reverse sweep on any device: the input adjoints, levels-major.

    Seeds are the 8 raw output cotangent streams; with ``fold_seeds`` they
    are the TL image and are folded by :func:`seed_scales` level by level,
    without it they are taken as they are (:func:`seed_streams` folded the
    10-field cotangent already).  Each level is recomputed from the
    raw fields and its carry checkpoint and transposed with
    ``torch.func.vjp``.  The shifted views scatter onto their sources:
    ``d_plu[k+1]`` takes the plu(k+1) cotangent of level k (``d_plu[0]`` is
    0: level 0 is never read as k+1, and the clamped last-level read has a
    zero cotangent), ``d_paph[k+1] = hi(k) + lo(k+1)``, ``d_paph[0] =
    lo(0)``, and the surface row adds the sum over levels of the paph_sfc
    cotangent.  ``pre`` replaces :func:`plain_prelude` of ``inputs`` where
    the caller has it.  ``inplace_scatter=False`` (the default with
    ``chunk_levels`` > 1, which takes no other) runs
    :func:`cloudsc2_ad_streams_reference` and assembles its 17 streams with
    :func:`assemble_shifted_adjoints`: the same adjoints bit for bit.
    """
    chunk_levels = check_chunk_levels(chunk_levels)
    if not _inplace(inplace_scatter, chunk_levels):
        return _assembled(cloudsc2_ad_streams_reference(
            inputs, d_outputs, checkpoints, params, lregcl=lregcl,
            ldrain1d=ldrain1d, fold_seeds=fold_seeds, pre=pre,
            chunk_levels=chunk_levels))
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = plain_prelude(inputs, params) if pre is None else pre
    nlev = inputs.pt.shape[0]
    srfl, ssfl = seed_scales(params) if fold_seeds else (1.0, 1.0)
    zero = torch.zeros_like(inputs.pt[0])
    dcarry = (zero, zero, zero)
    dlo = dsfc = zero
    cols = (pre.ztrpaus, pre.paph_sfc)
    d = {n: torch.empty_like(inputs.pt) for n in _LEVEL_FIELDS}
    d_plu = torch.empty_like(inputs.plu)
    d_paph = torch.empty_like(inputs.paph)
    for k in reversed(range(nlev)):
        carry_in = tuple(c[k] for c in checkpoints)
        _, vjp_fn = torch.func.vjp(
            _level_fn(params, ldrain1d, lregcl, pre, k, nlev),
            _level_fields(inputs, k, nlev), cols, carry_in)
        seeds = tuple(s[k] for s in d_outputs)
        seeds = seeds[:6] + (seeds[6] * srfl, seeds[7] * ssfl)
        dfields, dcols, dcarry = vjp_fn((seeds, dcarry))
        for n, v in zip(_LEVEL_FIELDS, dfields):
            d[n][k] = v
        if k < nlev - 1:
            d_plu[k + 1] = dfields[14]
        d_paph[k + 1] = dfields[16] + dlo
        dlo = dfields[15]
        dsfc = dsfc + dcols[1]
    d_plu[0] = 0.0
    d_paph[0] = dlo
    d_paph[nlev] = d_paph[nlev] + dsfc
    return Cloudsc2Inputs(paph=d_paph, plu=d_plu, **d)


@spans.spanned("ad_sweep")
def cloudsc2_ad_streams_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None, chunk_levels: int = 1,
) -> ShiftedAdjoints:
    """Plain reverse sweep under the 17-stream convention, on any device:
    the :class:`ShiftedAdjoints` of :func:`cloudsc2_ad_reference`'s loop,
    each level's 17 cotangents stored at its own slot and the paph_sfc
    cotangents summed over the levels in the same order.  ``chunk_levels``
    is checked and does not change the loop."""
    check_chunk_levels(chunk_levels)
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = plain_prelude(inputs, params) if pre is None else pre
    nlev = inputs.pt.shape[0]
    srfl, ssfl = seed_scales(params) if fold_seeds else (1.0, 1.0)
    zero = torch.zeros_like(inputs.pt[0])
    dcarry = (zero, zero, zero)
    dsfc = zero
    cols = (pre.ztrpaus, pre.paph_sfc)
    streams = [torch.empty_like(inputs.pt) for _ in range(len(_LEVEL_FIELDS) + 3)]
    for k in reversed(range(nlev)):
        carry_in = tuple(c[k] for c in checkpoints)
        _, vjp_fn = torch.func.vjp(
            _level_fn(params, ldrain1d, lregcl, pre, k, nlev),
            _level_fields(inputs, k, nlev), cols, carry_in)
        seeds = tuple(s[k] for s in d_outputs)
        seeds = seeds[:6] + (seeds[6] * srfl, seeds[7] * ssfl)
        dfields, dcols, dcarry = vjp_fn((seeds, dcarry))
        for buf, v in zip(streams, dfields):
            buf[k] = v
        dsfc = dsfc + dcols[1]
    return ShiftedAdjoints(*streams, dsfc)


# -------------------------------------------------------------- CUDA kernels
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# per library: the pointer arrays it takes, then its scalar arguments
# between the params array and the stream
_LAYOUT = {
    "cloudsc2_tl": (
        (TL_STREAMS, TL_OUTPUTS),
        [ctypes.c_double] + [ctypes.c_int] * 5),  # dscale; ncol nlev evap lregcl write_primal
    "cloudsc2_tl_din": (
        (TL_STREAMS, TL_TANGENT_STREAMS, TL_OUTPUTS),
        [ctypes.c_int] * 4),  # ncol nlev evap lregcl
    "cloudsc2_ad": (
        (AD_STREAMS, AD_OUTPUTS),
        [ctypes.c_double] * 2 + [ctypes.c_int] * 4),  # seed scales; ncol nlev evap lregcl
    "cloudsc2_ad_xscat": (
        (AD_STREAMS, AD_SHIFTED_OUTPUTS),
        [ctypes.c_double] * 2 + [ctypes.c_int] * 4),  # seed scales; ncol nlev evap lregcl
    # the chunked libraries: as their one-level twins, then chunk
    "cloudsc2_tl_chunk": (
        (TL_STREAMS, TL_OUTPUTS),
        [ctypes.c_double] + [ctypes.c_int] * 5),  # dscale; ncol nlev evap lregcl chunk
    "cloudsc2_tl_din_chunk": (
        (TL_STREAMS, TL_TANGENT_STREAMS, TL_OUTPUTS),
        [ctypes.c_int] * 5),  # ncol nlev evap lregcl chunk
    "cloudsc2_ad_chunk": (
        (AD_STREAMS, AD_SHIFTED_OUTPUTS),
        [ctypes.c_double] * 2 + [ctypes.c_int] * 5),  # seed scales; ncol nlev evap lregcl chunk
}


def _bind(name: str, layout=None, suffixes=("f32", "f64")):
    """Load ``csrc/<name>.cu``, check its argument layout against the
    wrapper's, and declare the launchers' argument types.  ``layout`` is an
    entry like ``_LAYOUT``'s for a library of another module, ``suffixes``
    the precisions it was built for."""
    from . import build

    lib = build.load_library(name)
    if getattr(lib, "_bound", False):
        return lib
    arrays, scalars = layout or _LAYOUT[name]
    abi = getattr(lib, f"{name}_abi")
    abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    abi.restype = ctypes.c_int
    counts = (ctypes.c_int * (len(arrays) + 1))()
    abi(counts)
    names_fn = getattr(lib, f"{name}_param_names")
    names_fn.argtypes = []
    names_fn.restype = ctypes.c_char_p
    lib.param_names = names_fn().decode().split()
    expected = tuple(len(a) for a in arrays) + (len(lib.param_names),)
    if tuple(counts) != expected:
        raise RuntimeError(f"{name}.cu argument layout {tuple(counts)} does "
                           f"not match the wrapper's {expected}")
    for suffix in suffixes:
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = ([_PTRS] * len(arrays) + [ctypes.POINTER(ctypes.c_double)]
                       + scalars + [ctypes.c_void_p])  # ..., params, ..., stream
        fn.restype = ctypes.c_int
    lib._bound = True
    return lib


def _param_array(lib, params: Params):
    from .emit import param_value

    return (ctypes.c_double * len(lib.param_names))(
        *(param_value(params, p) for p in lib.param_names))


# The counters of a kernel instance, in the order the libraries' occupancy
# entries write them (cloudsc2_occupancy::Counter in csrc/cloudsc2_occupancy.cuh).
OCCUPANCY = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")
_OCCUPANCY_READ = {}


def occupancy(name: str, like: torch.Tensor, *switches: int) -> dict:
    """What the instance of ``csrc/<name>.cu`` that a launch on ``like``'s
    dtype with ``switches`` (its ints after ``nlev``: evap, lregcl, and for
    the TL write_primal) runs costs an SM of ``like``'s card: ``dtype`` (its
    bits), then :data:`OCCUPANCY`, from ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's own
    block size and dynamic shared memory.  Read once per instance and card,
    then cached; ``name`` is ``cloudsc2_tl`` or ``cloudsc2_ad``."""
    key = (name, like.dtype, like.device, switches)
    got = _OCCUPANCY_READ.get(key)
    if got is None:
        bits = 32 if like.dtype == torch.float32 else 64
        fn = getattr(_bind(name), f"{name}_occupancy_f{bits}")
        fn.argtypes = [ctypes.c_int] * len(switches) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * len(OCCUPANCY))()
        with torch.cuda.device(like.device):
            err = fn(*switches, out)
        if err != 0:
            raise RuntimeError(f"{name}'s occupancy could not be read: cudaError_t {err}")
        got = _OCCUPANCY_READ[key] = {"dtype": bits, **dict(zip(OCCUPANCY, out))}
    return got


def _check_launch(inputs: Cloudsc2Inputs, params: Params, ldrain1d: bool,
                  what: str) -> None:
    if inputs.pt.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {inputs.pt.device}")
    _check_config(params, ldrain1d)
    _need_pqs(inputs)


def _call(lib, name: str, like: torch.Tensor, arrays, *args) -> None:
    """Launch ``<name>_f32|f64`` on the current stream with one pointer
    array per entry of ``arrays`` (``None`` gives a null pointer), then the
    params and ``args``; raises if the launch is refused."""
    fn = getattr(lib, name + ("_f32" if like.dtype == torch.float32 else "_f64"))
    ptrs = [(ctypes.c_void_p * len(xs))(
        *(None if x is None else x.data_ptr() for x in xs)) for xs in arrays]
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    dscale: float, ldrain1d: bool = False, write_primal: bool = True,
    lregcl: bool = True, chunk_levels: int = 1,
):
    """Launch the TL kernel on CUDA tensors, on the current stream: returns
    (outputs | None, tangents, checkpoints) like the plain version.

    Checks device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tl.launches``, and gives the ``tl_sweep`` span the counters
    of the instance (:func:`occupancy`); with ``chunk_levels`` C > 1
    launches the chunked kernel (``csrc/cloudsc2_tl_chunk.cu``, primal
    streams written) and counts it in ``cloudsc2_tl.launches_chunked``."""
    chunk_levels = check_chunk_levels(chunk_levels)
    _check_primal(write_primal, chunk_levels)
    _check_launch(inputs, params, ldrain1d, "launch_cloudsc2_tl")
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, TL_STREAMS, inputs.pt, "cloudsc2_tl")
    nlev, ncol = inputs.pt.shape
    name = "cloudsc2_tl" if chunk_levels == 1 else "cloudsc2_tl_chunk"
    lib = _bind(name)
    new = [torch.empty_like(inputs.pt) for _ in range(8 + 3)]
    prim = [torch.empty_like(inputs.pt) if write_primal else None
            for _ in range(8)]
    last = (int(write_primal),) if chunk_levels == 1 else (chunk_levels,)
    switches = (int(_evap(params, ldrain1d)), int(lregcl))
    _call(lib, name, inputs.pt,
          ([operands[n] for n in TL_STREAMS], new + prim),
          _param_array(lib, params), float(dscale), ncol, nlev, *switches, *last)
    if chunk_levels == 1:
        spans.count(lambda: occupancy(name, inputs.pt, *switches, *last))
        cloudsc2_tl.launches += 1
    else:
        cloudsc2_tl.launches_chunked += 1
    return (Cloudsc2StreamOutputs(*prim) if write_primal else None,
            Cloudsc2StreamOutputs(*new[:8]), tuple(new[8:]))


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl_din(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, pre: KernelPrelude,
    params: Params, *, ldrain1d: bool = False, lregcl: bool = False,
    chunk_levels: int = 1,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """Launch the streamed-increment TL kernel on CUDA tensors, on the
    current stream: returns (outputs, tangents).

    Checks device, dtype, shape and contiguity of the inputs and of the 16
    tangent streams, allocates the 8 + 8 outputs, and raises if the launch
    is refused.  Counts each launch in ``cloudsc2_tl_din.launches``; with
    ``chunk_levels`` C > 1 launches the chunked kernel
    (``csrc/cloudsc2_tl_din_chunk.cu``) and counts it in
    ``cloudsc2_tl_din.launches_chunked``."""
    chunk_levels = check_chunk_levels(chunk_levels)
    _check_launch(inputs, params, ldrain1d, "launch_cloudsc2_tl_din")
    _need_pqs(d_inputs)
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, TL_STREAMS, inputs.pt, "cloudsc2_tl_din")
    tangents = d_inputs._asdict()
    check_operands(tangents, TL_TANGENT_STREAMS, inputs.pt,
                   "cloudsc2_tl_din (tangents)")
    nlev, ncol = inputs.pt.shape
    name = "cloudsc2_tl_din" if chunk_levels == 1 else "cloudsc2_tl_din_chunk"
    lib = _bind(name)
    dout = [torch.empty_like(inputs.pt) for _ in range(8)]
    prim = [torch.empty_like(inputs.pt) for _ in range(8)]
    _call(lib, name, inputs.pt,
          ([operands[n] for n in TL_STREAMS],
           [tangents[n] for n in TL_TANGENT_STREAMS],
           dout + [None] * 3 + prim),
          _param_array(lib, params), ncol, nlev,
          int(_evap(params, ldrain1d)), int(lregcl),
          *(() if chunk_levels == 1 else (chunk_levels,)))
    if chunk_levels == 1:
        cloudsc2_tl_din.launches += 1
    else:
        cloudsc2_tl_din.launches_chunked += 1
    return Cloudsc2StreamOutputs(*prim), Cloudsc2StreamOutputs(*dout)


@spans.spanned("ad_sweep")
def launch_cloudsc2_ad(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, ldrain1d: bool = False,
    lregcl: bool = True, fold_seeds: bool = True,
) -> Cloudsc2Inputs:
    """Launch the reverse-adjoint kernel on CUDA tensors, on the current
    stream: returns the input adjoints like the plain version.

    Checks device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_ad.launches``, and gives the ``ad_sweep`` span the counters
    of the instance (:func:`occupancy`)."""
    _check_launch(inputs, params, ldrain1d, "launch_cloudsc2_ad")
    operands = {**inputs._asdict(), **pre._asdict(),
                **dict(zip(CHECKPOINTS, checkpoints)),
                **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    check_operands(operands, AD_STREAMS, inputs.pt, "cloudsc2_ad")
    nlev, ncol = inputs.pt.shape
    lib = _bind("cloudsc2_ad")
    outs = [torch.empty_like(inputs.pt) for _ in _LEVEL_FIELDS] + [
        torch.empty_like(inputs.plu), torch.empty_like(inputs.paph)]
    scales = seed_scales(params) if fold_seeds else (1.0, 1.0)
    switches = (int(_evap(params, ldrain1d)), int(lregcl))
    _call(lib, "cloudsc2_ad", inputs.pt,
          ([operands[n] for n in AD_STREAMS], outs),
          _param_array(lib, params), *scales, ncol, nlev, *switches)
    spans.count(lambda: occupancy("cloudsc2_ad", inputs.pt, *switches))
    cloudsc2_ad.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs))
    return Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d)


@spans.spanned("ad_sweep")
def launch_cloudsc2_ad_streams(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, ldrain1d: bool = False,
    lregcl: bool = True, fold_seeds: bool = True, chunk_levels: int = 1,
) -> ShiftedAdjoints:
    """Launch the reverse-adjoint kernel of the 17-stream convention on CUDA
    tensors, on the current stream: returns the raw :class:`ShiftedAdjoints`
    like :func:`cloudsc2_ad_streams_reference`.

    One level a step runs ``csrc/cloudsc2_ad_xscat.cu`` and counts in
    ``cloudsc2_ad.launches_xscat``; ``chunk_levels`` C > 1 runs
    ``csrc/cloudsc2_ad_chunk.cu`` and counts in
    ``cloudsc2_ad.launches_chunked``.  Checks as :func:`launch_cloudsc2_ad`."""
    chunk_levels = check_chunk_levels(chunk_levels)
    _check_launch(inputs, params, ldrain1d, "launch_cloudsc2_ad_streams")
    operands = {**inputs._asdict(), **pre._asdict(),
                **dict(zip(CHECKPOINTS, checkpoints)),
                **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    check_operands(operands, AD_STREAMS, inputs.pt, "cloudsc2_ad")
    nlev, ncol = inputs.pt.shape
    name = "cloudsc2_ad_xscat" if chunk_levels == 1 else "cloudsc2_ad_chunk"
    lib = _bind(name)
    outs = [torch.empty_like(inputs.pt) for _ in range(len(_LEVEL_FIELDS) + 3)]
    outs.append(torch.empty_like(inputs.pt[0]))
    scales = seed_scales(params) if fold_seeds else (1.0, 1.0)
    _call(lib, name, inputs.pt, ([operands[n] for n in AD_STREAMS], outs),
          _param_array(lib, params), *scales, ncol, nlev,
          int(_evap(params, ldrain1d)), int(lregcl),
          *(() if chunk_levels == 1 else (chunk_levels,)))
    if chunk_levels == 1:
        cloudsc2_ad.launches_xscat += 1
    else:
        cloudsc2_ad.launches_chunked += 1
    return ShiftedAdjoints(*outs)


# ------------------------------------------------------------------ wrappers
def _device(inputs: Cloudsc2Inputs, what: str) -> str:
    kind = inputs.pt.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {inputs.pt.device}")
    return kind


def cloudsc2_tl(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float,
    lregcl: bool = True, ldrain1d: bool = False, write_primal: bool = True,
    pre: Optional[KernelPrelude] = None, chunk_levels: int = 1,
):
    """The TL sweep with in-register increments ``dscale·x``: returns
    (outputs | None, tangents, checkpoints).

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_tl`);
    CPU tensors run the plain version :func:`cloudsc2_tl_reference`; any
    other device raises.  ``pre`` is :func:`kernel_prelude` of ``inputs``
    where the caller has it (computed here otherwise).  ``chunk_levels``: C
    levels a step (1 or one of :data:`CHUNK_LEVELS`; with more than one the
    primal streams are written, as ``cloudsc2_pallas_tl`` requires)."""
    kw = dict(dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d,
              write_primal=write_primal, chunk_levels=chunk_levels)
    if _device(inputs, "cloudsc2_tl") == "cpu":
        return cloudsc2_tl_reference(inputs, params, pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl(inputs, pre, params, **kw)


def cloudsc2_tl_din(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    lregcl: bool = False, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None, chunk_levels: int = 1,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """The TL sweep with streamed increments ``d_inputs`` (levels-major,
    shaped like ``inputs``): returns (outputs, tangents), 8 streams each.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_tl_din`); CPU tensors run the plain version
    :func:`cloudsc2_tl_reference`; any other device raises.  ``pre`` and
    ``chunk_levels`` as for :func:`cloudsc2_tl`."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, chunk_levels=chunk_levels)
    if _device(inputs, "cloudsc2_tl_din") == "cpu":
        out, dout, _ = cloudsc2_tl_reference(inputs, params, d_inputs=d_inputs,
                                             pre=pre, **kw)
        return out, dout
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl_din(inputs, d_inputs, pre, params, **kw)


def cloudsc2_ad(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
    inplace_scatter: Optional[bool] = None, chunk_levels: int = 1,
) -> Cloudsc2Inputs:
    """The reverse sweep from a forward sweep's carry checkpoints, seeded
    with 8 raw cotangent streams: returns the input adjoints, levels-major.
    With ``fold_seeds`` the seeds are the TL image and are folded in-sweep.

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_ad`);
    CPU tensors run the plain version :func:`cloudsc2_ad_reference`; any
    other device raises.  ``pre`` as for :func:`cloudsc2_tl`.
    ``inplace_scatter`` as ``cloudsc2_pallas_ad`` takes it (default on for
    one level a step, refused with more): off, the kernel writes the 17
    streams of :func:`launch_cloudsc2_ad_streams` and
    :func:`assemble_shifted_adjoints` adds them up, with the same results.
    ``chunk_levels``: C levels a step (1 or one of :data:`CHUNK_LEVELS`)."""
    chunk_levels = check_chunk_levels(chunk_levels)
    inplace = _inplace(inplace_scatter, chunk_levels)
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=fold_seeds)
    if _device(inputs, "cloudsc2_ad") == "cpu":
        return cloudsc2_ad_reference(inputs, d_outputs, checkpoints, params,
                                     pre=pre, inplace_scatter=inplace,
                                     chunk_levels=chunk_levels, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    if inplace:
        return launch_cloudsc2_ad(inputs, pre, d_outputs, checkpoints, params, **kw)
    return _assembled(launch_cloudsc2_ad_streams(
        inputs, pre, d_outputs, checkpoints, params, chunk_levels=chunk_levels,
        **kw))


cloudsc2_tl.launches = cloudsc2_tl.launches_chunked = 0
cloudsc2_tl_din.launches = cloudsc2_tl_din.launches_chunked = 0
cloudsc2_ad.launches = cloudsc2_ad.launches_xscat = cloudsc2_ad.launches_chunked = 0


# ------------------------------------------------------ the standard contract
@spans.spanned("levels_major")
def to_levels_major(tree):
    """``(ncol, nlev)`` fields -> contiguous levels-major ``(nlev, ncol)``
    tensors, as the same NamedTuple.  A field that already is a transposed
    view of a levels-major tensor (as :class:`Cloudsc2State` builds them)
    is not copied; ``None`` stays ``None``."""
    return type(tree)(*(None if x is None else x.T.contiguous() for x in tree))


@spans.spanned("contract")
def seed_streams(d_outputs: Cloudsc2Outputs, params: Params,
                 levels_major: bool = False) -> Cloudsc2StreamOutputs:
    """Cloudsc2Outputs cotangents -> the 8 per-level seed streams,
    levels-major (``_seed_streams``, ``tlad_kernel.py:134-150``).

    Transpose of the output assembly: the flux rows k+1 and both enthalpy
    fluxes seed the level-k rain/snow outputs (pfhpsl = -rlvtt·pfplsl,
    cloudsc2.F90:730-735; pfplsl[0] is the constant zero top row, its
    cotangent drops)."""
    d = d_outputs if levels_major else Cloudsc2Outputs(*(x.T for x in d_outputs))
    cst = params.yomcst
    seeds = Cloudsc2StreamOutputs(
        d.tenl_t, d.tenl_q, d.tenl_l, d.tenl_i, d.pclc, d.pcovptot,
        rfln=d.pfplsl[1:] - cst.rlvtt * d.pfhpsl[1:],
        sfln=d.pfplsn[1:] - cst.rlstt * d.pfhpsn[1:])
    return Cloudsc2StreamOutputs(*(x.contiguous() for x in seeds))


def cloudsc2_kernel_tl(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    lregcl: bool = False, ldrain1d: bool = False, levels_major: bool = False,
    pre: Optional[KernelPrelude] = None, chunk_levels: int = 1,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Outputs]:
    """Tangent-linear CLOUDSC2 through the streamed-increment sweep:
    returns (outputs, d_outputs) in the 10-field contract.

    Drop-in for :func:`cloudsc2jax_torch.tlad.cloudsc2_tl` on
    LPHYLIN=True: ``(ncol, nlev)`` inputs and increments (paph ``(ncol,
    nlev+1)``), or levels-major ones with ``levels_major``, which come back
    in the same layout.  CUDA tensors run :func:`cloudsc2_tl_din`'s kernel,
    CPU tensors its plain version.  ``pre`` is :func:`kernel_prelude` of the
    levels-major inputs where the caller has it; ``chunk_levels`` as for
    :func:`cloudsc2_tl_din`."""
    if not levels_major:
        inputs, d_inputs = to_levels_major(inputs), to_levels_major(d_inputs)
    out, dout = cloudsc2_tl_din(inputs, d_inputs, params, lregcl=lregcl,
                                ldrain1d=ldrain1d, pre=pre,
                                chunk_levels=chunk_levels)
    return (unblock_outputs(out, params, levels_major),
            unblock_outputs(dout, params, levels_major))


def cloudsc2_kernel_ad(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2Outputs, params: Params, *,
    lregcl: bool = True, ldrain1d: bool = False, levels_major: bool = False,
    pre: Optional[KernelPrelude] = None, inplace_scatter: Optional[bool] = None,
    chunk_levels: int = 1,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Inputs]:
    """Adjoint CLOUDSC2 through the checkpointing forward sweep and the
    reverse sweep: returns (outputs, input_adjoints).

    Drop-in for :func:`cloudsc2jax_torch.tlad.cloudsc2_ad` on
    LPHYLIN=True, with the layouts of :func:`cloudsc2_kernel_tl`.
    ``d_outputs`` is a cotangent on the 10-field contract;
    :func:`seed_streams` folds it into the 8 seed streams, so the reverse
    sweep applies no (1 + L²) fold of its own.  CUDA tensors run the two
    kernels after one :func:`kernel_prelude` for both (``pre`` where the
    caller has it), CPU tensors their plain versions.  ``chunk_levels``
    runs both sweeps C levels a step, and ``inplace_scatter`` picks the
    reverse sweep's convention, as for :func:`cloudsc2_ad`."""
    chunk_levels = check_chunk_levels(chunk_levels)
    inplace = _inplace(inplace_scatter, chunk_levels)
    if not levels_major:
        inputs = to_levels_major(inputs)
    seeds = seed_streams(d_outputs, params, levels_major)
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=False)
    if _device(inputs, "cloudsc2_kernel_ad") == "cpu":
        out, ckpts = cloudsc2_fwd_ckpt_reference(inputs, params, ldrain1d=ldrain1d,
                                                 pre=pre, chunk_levels=chunk_levels)
    else:
        pre = kernel_prelude(inputs, params) if pre is None else pre
        out, ckpts = launch_cloudsc2_fwd_ckpt(inputs, pre, params, ldrain1d=ldrain1d,
                                              chunk_levels=chunk_levels)
    adj = cloudsc2_ad(inputs, seeds, ckpts, params, pre=pre, inplace_scatter=inplace,
                      chunk_levels=chunk_levels, **kw)
    if not levels_major:
        adj = Cloudsc2Inputs(*(x.T for x in adj))
    return unblock_outputs(out, params, levels_major), adj
