"""The tangent-linear and reverse-adjoint sweeps: CUDA kernels and plain
versions.

Port of the work-unit path of :mod:`cloudsc2jax.pallas.tlad_kernel`:
``cloudsc2_pallas_tl(dscale=0.01, save_checkpoints=True, write_primal=…)``
(``_tl_kernel``) followed by ``cloudsc2_pallas_ad(checkpoints=…,
fold_seeds=True)`` (``_rev_kernel``, in-place scatter).  Streams are
levels-major ``(nlev, ncol)`` (paph ``(nlev+1, ncol)``) with no column
padding, and the TL/AD level sweeps read ``inputs.pqs`` as an independent
input (``Cloudsc2State.device_kernel_inputs(..., pqs=True)``).

* :func:`cloudsc2_tl` and :func:`cloudsc2_ad` are the wrappers.  A CUDA
  tensor goes to the hand-written kernel (``csrc/cloudsc2_tl.cu``,
  ``csrc/cloudsc2_ad.cu``), a CPU tensor to the plain version, any other
  device raises.  Each counts its kernel launches in ``.launches``.
* :func:`cloudsc2_tl_reference` and :func:`cloudsc2_ad_reference` are the
  plain versions: a Python loop over levels of ``torch.func.jvp`` of
  :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.level_physics`, and a
  reversed loop of ``torch.func.vjp`` from the carry checkpoints.
* The kernels' level bodies are generated from the same ``level_physics``
  by :mod:`cloudsc2jax_torch.kernels.emit`, with ``lregcl=True``; so the
  kernels take ``lregcl=True`` only, while the plain versions take both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs
from .cloudsc2_kernel import (
    KERNEL_OUTPUTS,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _check_config,
    _evap,
    check_operands,
    kernel_prelude,
    level_physics,
)

__all__ = [
    "AD_OUTPUTS",
    "AD_STREAMS",
    "TL_OUTPUTS",
    "TL_STREAMS",
    "cloudsc2_ad",
    "cloudsc2_ad_reference",
    "cloudsc2_tl",
    "cloudsc2_tl_reference",
    "fold_flux_seeds",
    "launch_cloudsc2_ad",
    "launch_cloudsc2_tl",
    "seed_scales",
]

Checkpoints = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# Argument arrays of the C launchers; names and order are those of the enums
# in csrc/cloudsc2_tl.cu and csrc/cloudsc2_ad.cu.
_COMMON = ("plu", "paph", "ceta", "zscalm", "ztrpaus", "paph_sfc")
_CKPT = ("ckpt_rfl", "ckpt_sfl", "ckpt_covptot")
TL_STREAMS = _LEVEL_FIELDS + _COMMON
TL_OUTPUTS = tuple("d_" + n for n in KERNEL_OUTPUTS) + _CKPT + KERNEL_OUTPUTS
AD_STREAMS = _LEVEL_FIELDS + _COMMON + _CKPT + tuple("seed_" + n for n in KERNEL_OUTPUTS)
AD_OUTPUTS = tuple("d_" + n for n in _LEVEL_FIELDS) + ("d_plu", "d_paph")


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


# ------------------------------------------------------------ plain versions
def cloudsc2_tl_reference(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float,
    lregcl: bool = True, ldrain1d: bool = False, write_primal: bool = True,
) -> Tuple[Optional[Cloudsc2StreamOutputs], Cloudsc2StreamOutputs, Checkpoints]:
    """Plain TL sweep on any device: returns (outputs | None, tangents,
    checkpoints).

    The increments are ``dscale·x`` of every level value and of paph_sfc;
    the tropopause eta has a zero tangent (``tlad_kernel.py:238-245``).
    ``checkpoints`` are the 3 carries (rfl, sfl, covptot) going INTO each
    level, ``(nlev, ncol)`` each.
    """
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = kernel_prelude(inputs, params)
    nlev = inputs.pt.shape[0]
    zero = torch.zeros_like(inputs.pt[0])
    carry = dcarry = (zero, zero, zero)
    cols = (pre.ztrpaus, pre.paph_sfc)
    dcols = (torch.zeros_like(pre.ztrpaus), dscale * pre.paph_sfc)
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
            (tuple(dscale * x for x in fields), dcols, dcarry),
        )
        if outs is not None:
            for buf, v in zip(outs, out):
                buf[k] = v
        for buf, v in zip(douts, dout):
            buf[k] = v
        carry, dcarry = newc, dnewc
    return (None if outs is None else Cloudsc2StreamOutputs(*outs),
            Cloudsc2StreamOutputs(*douts), ckpts)


def cloudsc2_ad_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False,
) -> Cloudsc2Inputs:
    """Plain reverse sweep on any device: the input adjoints, levels-major.

    Seeds are the 8 raw output cotangent streams (the TL image), folded by
    :func:`seed_scales` level by level.  Each level is recomputed from the
    raw fields and its carry checkpoint and transposed with
    ``torch.func.vjp``.  The shifted views scatter onto their sources:
    ``d_plu[k+1]`` takes the plu(k+1) cotangent of level k (``d_plu[0]`` is
    0: level 0 is never read as k+1, and the clamped last-level read has a
    zero cotangent), ``d_paph[k+1] = hi(k) + lo(k+1)``, ``d_paph[0] =
    lo(0)``, and the surface row adds the sum over levels of the paph_sfc
    cotangent.
    """
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = kernel_prelude(inputs, params)
    nlev = inputs.pt.shape[0]
    srfl, ssfl = seed_scales(params)
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


# -------------------------------------------------------------- CUDA kernels
def _bind(name: str, extra_doubles: int):
    """Load ``csrc/<name>.cu``, check its argument layout against the
    wrapper's, and declare the launchers' argument types."""
    from . import build

    lib = build.load_library(name)
    if getattr(lib, "_bound", False):
        return lib
    streams, outputs = {"cloudsc2_tl": (TL_STREAMS, TL_OUTPUTS),
                        "cloudsc2_ad": (AD_STREAMS, AD_OUTPUTS)}[name]
    abi = getattr(lib, f"{name}_abi")
    abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    abi.restype = ctypes.c_int
    counts = (ctypes.c_int * 3)()
    abi(counts)
    names_fn = getattr(lib, f"{name}_param_names")
    names_fn.argtypes = []
    names_fn.restype = ctypes.c_char_p
    lib.param_names = names_fn().decode().split()
    expected = (len(streams), len(outputs), len(lib.param_names))
    if tuple(counts) != expected:
        raise RuntimeError(f"{name}.cu argument layout {tuple(counts)} does "
                           f"not match the wrapper's {expected}")
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = (
            [ctypes.POINTER(ctypes.c_void_p),  # in
             ctypes.POINTER(ctypes.c_void_p),  # out
             ctypes.POINTER(ctypes.c_double)]  # params
            + [ctypes.c_double] * extra_doubles
            + [ctypes.c_int, ctypes.c_int,  # ncol, nlev
               ctypes.c_int]  # evap
            + ([ctypes.c_int] if name == "cloudsc2_tl" else [])  # write_primal
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
    lib._bound = True
    return lib


def _param_array(lib, params: Params):
    from .emit import param_value

    return (ctypes.c_double * len(lib.param_names))(
        *(param_value(params, p) for p in lib.param_names))


def _check_launch(inputs: Cloudsc2Inputs, params: Params, ldrain1d: bool,
                  lregcl: bool, what: str) -> None:
    if inputs.pt.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {inputs.pt.device}")
    if not lregcl:
        raise NotImplementedError(
            f"{what}: the kernel's level body is generated with lregcl=True "
            "(run the plain version on CPU tensors for lregcl=False)")
    _check_config(params, ldrain1d)
    _need_pqs(inputs)


def _call(fn, ins, outs, *args) -> None:
    like = ins[0]
    in_ptrs = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(
        *(None if x is None else x.data_ptr() for x in outs))
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(in_ptrs, out_ptrs, *args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError_t {err}")


def launch_cloudsc2_tl(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    dscale: float, ldrain1d: bool = False, write_primal: bool = True,
    lregcl: bool = True,
):
    """Launch the TL kernel on CUDA tensors, on the current stream: returns
    (outputs | None, tangents, checkpoints) like the plain version.

    Checks device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tl.launches``."""
    _check_launch(inputs, params, ldrain1d, lregcl, "launch_cloudsc2_tl")
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, TL_STREAMS, inputs.pt, "cloudsc2_tl")
    nlev, ncol = inputs.pt.shape
    lib = _bind("cloudsc2_tl", 1)
    new = [torch.empty_like(inputs.pt) for _ in range(8 + 3)]
    prim = [torch.empty_like(inputs.pt) if write_primal else None
            for _ in range(8)]
    fn = lib.cloudsc2_tl_f32 if inputs.pt.dtype == torch.float32 \
        else lib.cloudsc2_tl_f64
    _call(fn, [operands[n] for n in TL_STREAMS], new + prim,
          _param_array(lib, params), float(dscale), ncol, nlev,
          int(_evap(params, ldrain1d)), int(write_primal))
    cloudsc2_tl.launches += 1
    return (Cloudsc2StreamOutputs(*prim) if write_primal else None,
            Cloudsc2StreamOutputs(*new[:8]), tuple(new[8:]))


def launch_cloudsc2_ad(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, ldrain1d: bool = False,
    lregcl: bool = True,
) -> Cloudsc2Inputs:
    """Launch the reverse-adjoint kernel on CUDA tensors, on the current
    stream: returns the input adjoints like the plain version.

    Checks device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_ad.launches``."""
    _check_launch(inputs, params, ldrain1d, lregcl, "launch_cloudsc2_ad")
    operands = {**inputs._asdict(), **pre._asdict(),
                **dict(zip(_CKPT, checkpoints)),
                **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    check_operands(operands, AD_STREAMS, inputs.pt, "cloudsc2_ad")
    nlev, ncol = inputs.pt.shape
    lib = _bind("cloudsc2_ad", 2)
    outs = [torch.empty_like(inputs.pt) for _ in _LEVEL_FIELDS] + [
        torch.empty_like(inputs.plu), torch.empty_like(inputs.paph)]
    fn = lib.cloudsc2_ad_f32 if inputs.pt.dtype == torch.float32 \
        else lib.cloudsc2_ad_f64
    _call(fn, [operands[n] for n in AD_STREAMS], outs,
          _param_array(lib, params), *seed_scales(params), ncol, nlev,
          int(_evap(params, ldrain1d)))
    cloudsc2_ad.launches += 1
    d = dict(zip(_LEVEL_FIELDS, outs))
    return Cloudsc2Inputs(plu=outs[-2], paph=outs[-1], **d)


# ------------------------------------------------------------------ wrappers
def _device(inputs: Cloudsc2Inputs, what: str) -> str:
    kind = inputs.pt.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {inputs.pt.device}")
    return kind


def cloudsc2_tl(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float,
    lregcl: bool = True, ldrain1d: bool = False, write_primal: bool = True,
):
    """The TL sweep with in-register increments ``dscale·x``: returns
    (outputs | None, tangents, checkpoints).

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_tl`,
    after :func:`kernel_prelude`); CPU tensors run the plain version
    :func:`cloudsc2_tl_reference`; any other device raises."""
    kw = dict(dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d,
              write_primal=write_primal)
    if _device(inputs, "cloudsc2_tl") == "cpu":
        return cloudsc2_tl_reference(inputs, params, **kw)
    return launch_cloudsc2_tl(inputs, kernel_prelude(inputs, params), params, **kw)


def cloudsc2_ad(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False,
) -> Cloudsc2Inputs:
    """The reverse sweep from the TL sweep's carry checkpoints, seeded with
    the 8 raw tangent streams (folded in-sweep): returns the input
    adjoints, levels-major.

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_ad`);
    CPU tensors run the plain version :func:`cloudsc2_ad_reference`; any
    other device raises."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d)
    if _device(inputs, "cloudsc2_ad") == "cpu":
        return cloudsc2_ad_reference(inputs, d_outputs, checkpoints, params, **kw)
    return launch_cloudsc2_ad(inputs, kernel_prelude(inputs, params), d_outputs,
                              checkpoints, params, **kw)


cloudsc2_tl.launches = 0
cloudsc2_ad.launches = 0
