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
  kernel instance it launched
  (:func:`~cloudsc2jax_torch.kernels.build.occupancy`).
* :func:`cloudsc2_tl_din` is the TL sweep with STREAMED increments
  (``_tl_kernel`` without ``dscale``): its kernel
  (``csrc/cloudsc2_tl_din.cu``) reads a second set of 16 streams and
  writes no checkpoints.
* :func:`cloudsc2_tl_std` is :func:`cloudsc2_tl`'s sweep with the primal
  written, from a second build of ``csrc/cloudsc2_tl.cu`` without FMA
  contraction (``build.NO_FMA``), as the standard contract's unit runs it.
* The schedules JAX keeps beside those (C levels a step, the 17-stream
  adjoint convention) are :mod:`~cloudsc2jax_torch.kernels.schedules`.
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
``levels_major=True`` skips them.  Both assemble the contract in place
(:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.assemble_contract`):
the sweeps write their flux rows into the contract's flux fields.  The
standard contract's work unit (``drivers.run_tlad(backend="kernels")``)
runs one forward sweep and the reverse sweep: the TL forms the increments
``DSCALE·x`` in registers and writes the primal, the tangents and the
carry checkpoints (:func:`cloudsc2_tl_std`), :func:`tl_contract` assembles
both contracts, the tangent's with the reverse sweep's seeds in the same
launch, and :func:`ad_from_seeds` runs the AD from those checkpoints, with
no forward-checkpoint sweep.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache, partial
from typing import Optional, Tuple

import torch

from .. import spans
from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from . import build
from .cloudsc2_kernel import (
    CHECKPOINTS,
    KERNEL_OUTPUTS,
    Checkpoints,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _check_config,
    _evap,
    assemble_contract,
    check_operands,
    cloudsc2_fwd_ckpt_reference,
    flux_rows,
    flux_seeds,
    flux_slots,
    kernel_prelude,
    plain_prelude,
    launch_cloudsc2_fwd_ckpt,
    level_physics,
    output_buffers,
)

__all__ = [
    "AD_OUTPUTS",
    "AD_STREAMS",
    "TL_OUTPUTS",
    "TL_STREAMS",
    "TL_TANGENT_STREAMS",
    "ad_from_seeds",
    "cloudsc2_ad",
    "cloudsc2_ad_reference",
    "cloudsc2_kernel_ad",
    "cloudsc2_kernel_tl",
    "cloudsc2_tl",
    "cloudsc2_tl_din",
    "cloudsc2_tl_reference",
    "cloudsc2_tl_std",
    "fold_flux_seeds",
    "launch_cloudsc2_ad",
    "launch_cloudsc2_tl",
    "launch_cloudsc2_tl_din",
    "launch_cloudsc2_tl_std",
    "level_counts",
    "seed_scales",
    "seed_streams",
    "tl_contract",
    "to_levels_major",
]

# Argument arrays of the C launchers; names and order are those of the enums
# in csrc/cloudsc2_tl_sweep.cuh and csrc/cloudsc2_ad_sweep.cuh.
_COMMON = ("plu", "paph", "ceta", "zscalm", "ztrpaus", "paph_sfc")
TL_STREAMS = _LEVEL_FIELDS + _COMMON
TL_TANGENT_STREAMS = _LEVEL_FIELDS + ("plu", "paph")
TL_OUTPUTS = tuple("d_" + n for n in KERNEL_OUTPUTS) + CHECKPOINTS + KERNEL_OUTPUTS
AD_STREAMS = _LEVEL_FIELDS + _COMMON + CHECKPOINTS + tuple("seed_" + n for n in KERNEL_OUTPUTS)
# the tangent streams' names among a TL sweep's ``out`` (primal: KERNEL_OUTPUTS)
_TANGENT_OUTPUTS = TL_OUTPUTS[:8]
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
def _one_increment(dscale, d_inputs) -> None:
    if (d_inputs is None) == (dscale is None):
        raise ValueError("provide exactly one of d_inputs or dscale")


@spans.spanned("tl_sweep")
def cloudsc2_tl_reference(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: Optional[float] = None,
    d_inputs: Optional[Cloudsc2Inputs] = None,
    lregcl: bool = True, ldrain1d: bool = False, write_primal: bool = True,
    pre: Optional[KernelPrelude] = None, out=None,
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
    ``out`` gives outputs by name, as to the kernels (``rfln``, ``d_rfln``,
    ...; :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.output_buffers`).
    """
    _one_increment(dscale, d_inputs)
    _check_config(params, ldrain1d)
    _need_pqs(inputs)
    pre = plain_prelude(inputs, params) if pre is None else pre
    nlev = inputs.pt.shape[0]
    zero = torch.zeros_like(inputs.pt[0])
    carry = dcarry = (zero, zero, zero)
    cols = (pre.ztrpaus, pre.paph_sfc)
    dcols = (torch.zeros_like(pre.ztrpaus),
             dscale * pre.paph_sfc if d_inputs is None else d_inputs.paph[nlev])
    names = _TANGENT_OUTPUTS + (KERNEL_OUTPUTS if write_primal else ())
    bufs = output_buffers(names, out, inputs.pt, "the plain TL sweep")
    douts, outs = bufs[:8], (bufs[8:] if write_primal else None)
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
    the caller has it.
    """
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
}
def _binding(name: str, layout, suffixes=("f32", "f64"), queries=None,
             stamped=False) -> dict:
    """:func:`~cloudsc2jax_torch.kernels.build.bind`'s arguments for a
    library of the TL/AD family, whose launchers take one pointer array per
    entry of ``layout[0]``, the params array, the scalars ``layout[1]`` and
    the stream, for each precision of ``suffixes``; with ``stamped`` also
    ``<name>_stamped``, which takes the warps' records before the stream
    (:func:`~cloudsc2jax_torch.spans.stamped`); ``queries`` adds
    entries by name and argument types.  Its ``*_abi`` writes the arrays'
    lengths, then the params' count, which :func:`_param_array` checks
    against the names ``<name>_param_names`` returns."""
    arrays, scalars = layout
    args = [_PTRS] * len(arrays) + [ctypes.POINTER(ctypes.c_double)] + scalars
    launchers = {f"{entry}_{s}": args + [ctypes.c_void_p] * (1 + (entry != name))
                 for entry in ((name, f"{name}_stamped") if stamped else (name,))
                 for s in suffixes}
    return {"layouts": {f"{name}_abi": tuple(len(a) for a in arrays) + (None,)},
            "launchers": {**launchers, **(queries or {})},
            "strings": (f"{name}_param_names",)}


# the TL and AD libraries' occupancy entries (``build.occupancy``), and
# their stamped twins': the ints they take before their counters are the
# launch's after nlev (evap, lregcl, and for the TL write_primal)
_OCCUPANCY_QUERIES = {name: {**build.occupancy_queries(name, n),
                             **build.occupancy_queries(f"{name}_stamped", n)}
                      for name, n in (("cloudsc2_tl", 3), ("cloudsc2_ad", 2))}
_BINDINGS = {name: _binding(name, layout, queries=_OCCUPANCY_QUERIES.get(name),
                            stamped=name in _OCCUPANCY_QUERIES)
             for name, layout in _LAYOUT.items()}


def _library(name: str, flags=()):
    return build.bind(name, flags=flags, **_BINDINGS[name])


@lru_cache(maxsize=None)
def level_counts(kind: str, evap: bool, lregcl: bool) -> dict:
    """The counts the generated header of ``kind`` ("tl" or "ad") states
    for its level body ``Level<evap, lregcl>``: its division statements
    (``kDivides``, ``kReciprocals``, per level and column) and, in the AD,
    the shared-memory slots a thread parks values in (``kStashSlots``):
    ``{"divides": n, "reciprocals": m}``, the AD's with ``"stash_slots"``."""
    text = (build.CSRC / f"cloudsc2_{kind}_level.cuh").read_text()
    flags = f"{str(bool(evap)).lower()}, {str(bool(lregcl)).lower()}"
    body = re.search(rf"struct Level<{flags}> {{.*?\n}};", text, re.S).group(0)
    names = (("divides", "Divides"), ("reciprocals", "Reciprocals"))
    if kind == "ad":
        names += (("stash_slots", "StashSlots"),)
    return {key: int(re.search(rf"k{name} = (\d+);", body).group(1))
            for key, name in names}


def _param_array(lib, name: str, params: Params):
    """The params array of a launch of ``csrc/<name>.cu``: the values of the
    names its ``<name>_param_names`` gives, read once per library, held to
    the count its ``*_abi`` wrote (:func:`_binding`) and cached on it."""
    from .emit import param_value

    names = getattr(lib, "param_names", None)
    if names is None:
        names = getattr(lib, f"{name}_param_names")().decode().split()
        counts = lib.layouts[f"{name}_abi"]
        if counts[-1] != len(names):
            raise RuntimeError(f"{name}.cu argument layout {counts} does not match "
                               f"the wrapper's {counts[:-1] + (len(names),)}")
        lib.param_names = names
    return (ctypes.c_double * len(names))(*(param_value(params, p) for p in names))


def _check_launch(inputs: Cloudsc2Inputs, params: Params, ldrain1d: bool,
                  what: str) -> None:
    if inputs.pt.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {inputs.pt.device}")
    _check_config(params, ldrain1d)
    _need_pqs(inputs)


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    dscale: float, ldrain1d: bool = False, write_primal: bool = True,
    lregcl: bool = True,
):
    """Launch the TL kernel on CUDA tensors, on the current stream: returns
    (outputs | None, tangents, checkpoints) like the plain version.

    Checks device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tl.launches``, and gives the ``tl_sweep`` span the counters
    of the instance (:func:`~cloudsc2jax_torch.kernels.build.sweep_occupancy`),
    ``evap`` (1 where it ran the evaporating body) and the divisions of its
    level body (:func:`level_counts`).  In the recorded calls that stamp it
    launches the kernel's twin that stamps each warp
    (:func:`~cloudsc2jax_torch.spans.stamped`)."""
    entry, records = spans.stamped("cloudsc2_tl", inputs.pt, inputs.pt.shape[-1])
    outs = _tl_launch("cloudsc2_tl", _library, inputs, pre, params, dscale=dscale,
                      ldrain1d=ldrain1d, lregcl=lregcl, write_primal=write_primal,
                      extra=(int(write_primal),), entry=entry, records=records)
    switches = (int(_evap(params, ldrain1d)), int(lregcl), int(write_primal))
    spans.count(lambda: {**build.sweep_occupancy(_library("cloudsc2_tl"), "cloudsc2_tl",
                                                 entry, inputs.pt, *switches),
                         "evap": switches[0], **level_counts("tl", *switches[:2])})
    cloudsc2_tl.launches += 1
    return outs


def _tl_launch(name: str, library, inputs: Cloudsc2Inputs, pre: KernelPrelude,
               params: Params, *, dscale: float, ldrain1d: bool, lregcl: bool,
               write_primal: bool, extra, out=None, entry=None, records=()):
    """Check the operands of an in-register-increment TL launch, allocate
    its outputs (the primal streams with ``write_primal``) but those ``out``
    gives by name (``rfln``, ``d_rfln``, ...: the flux rows of
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.flux_slots`), and
    launch ``csrc/<name>.cu``, bound by ``library(name)``, with ``extra``
    after ``lregcl``, through ``entry`` (the stamped twin that
    :func:`~cloudsc2jax_torch.spans.stamped` picks, with ``records`` before
    the stream) where given: ``(outputs | None, tangents, checkpoints)``."""
    _check_launch(inputs, params, ldrain1d, f"launch_{name}")
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, TL_STREAMS, inputs.pt, name)
    nlev, ncol = inputs.pt.shape
    lib = library(name)
    names = _TANGENT_OUTPUTS + (KERNEL_OUTPUTS if write_primal else ())
    bufs = output_buffers(names, out, inputs.pt, name)
    dout, prim = bufs[:8], (bufs[8:] if write_primal else [None] * 8)
    ckpts = [torch.empty_like(inputs.pt) for _ in CHECKPOINTS]
    build.launch(lib, entry or name, inputs.pt, [operands[n] for n in TL_STREAMS],
                 dout + ckpts + prim, _param_array(lib, name, params), float(dscale),
                 ncol, nlev, int(_evap(params, ldrain1d)), int(lregcl), *extra, *records)
    return (Cloudsc2StreamOutputs(*prim) if write_primal else None,
            Cloudsc2StreamOutputs(*dout), tuple(ckpts))


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl_std(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    dscale: float, ldrain1d: bool = False, lregcl: bool = True, out=None,
):
    """Launch the standard contract's in-register-increment TL kernel, the
    build of ``csrc/cloudsc2_tl.cu`` without FMA contraction
    (``build.NO_FMA``), on CUDA tensors, on the current stream: returns
    (outputs, tangents, checkpoints), the primal always written.

    Checks device, dtype, shape and contiguity, allocates the outputs but
    those ``out`` gives by name (the flux rows of
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.flux_slots`), and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tl_std.launches``, and gives the ``tl_sweep`` span the
    counters of the instance
    (:func:`~cloudsc2jax_torch.kernels.build.sweep_occupancy`), ``evap`` (1
    where it ran the evaporating body), the divisions of its level body
    (:func:`level_counts`) and ``checkpoints`` 1: the carries of the reverse
    sweep were written.  In the recorded calls that stamp it launches the
    kernel's twin that stamps each warp
    (:func:`~cloudsc2jax_torch.spans.stamped`)."""
    entry, records = spans.stamped("cloudsc2_tl", inputs.pt, inputs.pt.shape[-1])
    outs = _tl_launch("cloudsc2_tl", partial(_library, flags=build.NO_FMA), inputs, pre,
                      params, dscale=dscale, ldrain1d=ldrain1d, lregcl=lregcl,
                      write_primal=True, extra=(1,), out=out, entry=entry, records=records)
    switches = (int(_evap(params, ldrain1d)), int(lregcl), 1)
    spans.count(lambda: {**build.sweep_occupancy(_library("cloudsc2_tl", build.NO_FMA),
                                                 "cloudsc2_tl", entry, inputs.pt, *switches),
                         "evap": switches[0], **level_counts("tl", *switches[:2]),
                         "checkpoints": 1})
    cloudsc2_tl_std.launches += 1
    return outs


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl_din(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, pre: KernelPrelude,
    params: Params, *, ldrain1d: bool = False, lregcl: bool = False, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """Launch the streamed-increment TL kernel on CUDA tensors, on the
    current stream: returns (outputs, tangents).

    Checks device, dtype, shape and contiguity of the inputs and of the 16
    tangent streams, allocates the 8 + 8 outputs but those ``out`` gives by
    name (``rfln``, ``d_rfln``, ...: the flux rows of
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.flux_slots`), and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_tl_din.launches``, and gives the ``tl_sweep`` span ``evap``
    (1 where it ran the evaporating body) and the divisions of its level
    body (:func:`level_counts`)."""
    outs = _tl_din_launch("cloudsc2_tl_din", _library, inputs, d_inputs, pre, params,
                          ldrain1d=ldrain1d, lregcl=lregcl, out=out)
    evap = int(_evap(params, ldrain1d))
    spans.count(lambda: {"evap": evap, **level_counts("tl", evap, int(lregcl))})
    cloudsc2_tl_din.launches += 1
    return outs


def _tl_din_launch(name: str, library, inputs: Cloudsc2Inputs,
                  d_inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
                  ldrain1d: bool, lregcl: bool, out=None, extra=()):
    """Check the operands of a streamed-increment TL launch, allocate its
    outputs but those ``out`` gives, and launch ``csrc/<name>.cu``, bound by
    ``library(name)``, with ``extra`` after ``lregcl``: ``(outputs,
    tangents)``."""
    _check_launch(inputs, params, ldrain1d, f"launch_{name}")
    _need_pqs(d_inputs)
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, TL_STREAMS, inputs.pt, name)
    tangents = d_inputs._asdict()
    check_operands(tangents, TL_TANGENT_STREAMS, inputs.pt, f"{name} (tangents)")
    nlev, ncol = inputs.pt.shape
    lib = library(name)
    bufs = output_buffers(_TANGENT_OUTPUTS + KERNEL_OUTPUTS, out, inputs.pt, name)
    dout, prim = bufs[:8], bufs[8:]
    build.launch(lib, name, inputs.pt, [operands[n] for n in TL_STREAMS],
                 [tangents[n] for n in TL_TANGENT_STREAMS], dout + [None] * 3 + prim,
                 _param_array(lib, name, params), ncol, nlev,
                 int(_evap(params, ldrain1d)), int(lregcl), *extra)
    return Cloudsc2StreamOutputs(*prim), Cloudsc2StreamOutputs(*dout)


def _ad_operands(inputs: Cloudsc2Inputs, pre: KernelPrelude,
                d_outputs: Cloudsc2StreamOutputs, checkpoints: Checkpoints,
                what: str):
    """The reverse sweep's operands in the order of :data:`AD_STREAMS`,
    checked for device, dtype, shape and contiguity."""
    operands = {**inputs._asdict(), **pre._asdict(),
                **dict(zip(CHECKPOINTS, checkpoints)),
                **{"seed_" + n: x for n, x in zip(KERNEL_OUTPUTS, d_outputs)}}
    check_operands(operands, AD_STREAMS, inputs.pt, what)
    return [operands[n] for n in AD_STREAMS]


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
    of the instance (:func:`~cloudsc2jax_torch.kernels.build.sweep_occupancy`),
    ``evap`` (1 where it ran the evaporating body) and the divisions and
    shared-memory slots of its level body (:func:`level_counts`).  In the
    recorded calls that stamp it launches the kernel's twin that stamps each
    warp (:func:`~cloudsc2jax_torch.spans.stamped`)."""
    _check_launch(inputs, params, ldrain1d, "launch_cloudsc2_ad")
    streams = _ad_operands(inputs, pre, d_outputs, checkpoints, "cloudsc2_ad")
    nlev, ncol = inputs.pt.shape
    lib = _library("cloudsc2_ad")
    outs = [torch.empty_like(inputs.pt) for _ in _LEVEL_FIELDS] + [
        torch.empty_like(inputs.plu), torch.empty_like(inputs.paph)]
    scales = seed_scales(params) if fold_seeds else (1.0, 1.0)
    switches = (int(_evap(params, ldrain1d)), int(lregcl))
    entry, stamps = spans.stamped("cloudsc2_ad", inputs.pt, ncol)
    build.launch(lib, entry, inputs.pt, streams, outs,
                 _param_array(lib, "cloudsc2_ad", params), *scales, ncol, nlev,
                 *switches, *stamps)
    spans.count(lambda: {**build.sweep_occupancy(lib, "cloudsc2_ad", entry, inputs.pt,
                                                 *switches),
                         "evap": switches[0], **level_counts("ad", *switches)})
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
    pre: Optional[KernelPrelude] = None,
):
    """The TL sweep with in-register increments ``dscale·x``: returns
    (outputs | None, tangents, checkpoints).

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_tl`);
    CPU tensors run the plain version :func:`cloudsc2_tl_reference`; any
    other device raises.  ``pre`` is :func:`kernel_prelude` of ``inputs``
    where the caller has it (computed here otherwise)."""
    kw = dict(dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d,
              write_primal=write_primal)
    if _device(inputs, "cloudsc2_tl") == "cpu":
        return cloudsc2_tl_reference(inputs, params, pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl(inputs, pre, params, **kw)


def cloudsc2_tl_std(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float,
    lregcl: bool = True, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs, Checkpoints]:
    """The standard contract's TL sweep: :func:`cloudsc2_tl` with the primal
    written, its kernel built without FMA contraction, so that its primal and
    tangents are :func:`cloudsc2_tl_din`'s on the increments ``dscale·x``
    bit for bit: returns (outputs, tangents, checkpoints).

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_tl_std`); CPU tensors run the plain version
    :func:`cloudsc2_tl_reference`; any other device raises.  ``pre`` as for
    :func:`cloudsc2_tl`; both write the outputs ``out`` gives by name into
    those tensors."""
    kw = dict(dscale=dscale, lregcl=lregcl, ldrain1d=ldrain1d, out=out)
    if _device(inputs, "cloudsc2_tl_std") == "cpu":
        return cloudsc2_tl_reference(inputs, params, pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl_std(inputs, pre, params, **kw)


def cloudsc2_tl_din(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    lregcl: bool = False, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """The TL sweep with streamed increments ``d_inputs`` (levels-major,
    shaped like ``inputs``): returns (outputs, tangents), 8 streams each.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_tl_din`); CPU tensors run the plain version
    :func:`cloudsc2_tl_reference`; any other device raises.  ``pre`` as for
    :func:`cloudsc2_tl`; both write the outputs ``out`` gives by name into
    those tensors."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, out=out)
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
) -> Cloudsc2Inputs:
    """The reverse sweep from a forward sweep's carry checkpoints, seeded
    with 8 raw cotangent streams: returns the input adjoints, levels-major.
    With ``fold_seeds`` the seeds are the TL image and are folded in-sweep.

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_ad`);
    CPU tensors run the plain version :func:`cloudsc2_ad_reference`; any
    other device raises.  ``pre`` as for :func:`cloudsc2_tl`."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=fold_seeds)
    if _device(inputs, "cloudsc2_ad") == "cpu":
        return cloudsc2_ad_reference(inputs, d_outputs, checkpoints, params,
                                     pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_ad(inputs, pre, d_outputs, checkpoints, params, **kw)


cloudsc2_tl.launches = 0
cloudsc2_tl_std.launches = 0
cloudsc2_tl_din.launches = 0
cloudsc2_ad.launches = 0


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

    Transpose of the output assembly: the rain and snow streams are
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.flux_seeds` of the
    flux and enthalpy-flux cotangents."""
    d = d_outputs if levels_major else Cloudsc2Outputs(*(x.T for x in d_outputs))
    rfln, sfln = flux_seeds(d, params)
    seeds = Cloudsc2StreamOutputs(
        d.tenl_t, d.tenl_q, d.tenl_l, d.tenl_i, d.pclc, d.pcovptot,
        rfln=rfln, sfln=sfln)
    return Cloudsc2StreamOutputs(*(x.contiguous() for x in seeds))


def tl_contract(sweep, like: torch.Tensor, params: Params, *, seeds: bool):
    """The standard contract's TL half around a levels-major TL ``sweep``:
    ``(outputs, d_outputs, seeds | None, *rest)``, two levels-major
    :class:`Cloudsc2Outputs`, with ``seeds`` the 8 seed streams of the
    reverse sweep for the tangent (:func:`seed_streams` of ``d_outputs``,
    folded: the AD takes them with ``fold_seeds=False``), then what else the
    sweep returned.

    ``sweep(out)`` runs a TL sweep (:func:`cloudsc2_tl_std`,
    :func:`cloudsc2_tl_din`) that writes its flux rows into the contract's
    flux fields, the slots ``out`` gives, and returns ``(outputs, tangents,
    *rest)``; ``like`` is a levels-major field of its inputs.  One
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.assemble_contract`
    each finishes the primal and the tangent in place, the tangent's with
    the seeds."""
    flux, d_flux = flux_rows(like), flux_rows(like)
    out, dout, *rest = sweep({**flux_slots(flux), **flux_slots(d_flux, "d_")})
    res, _ = assemble_contract(out, params, flux=flux)
    dres, sd = assemble_contract(dout, params, flux=d_flux, seeds=seeds)
    return (res, dres, None if sd is None else dout._replace(rfln=sd[0], sfln=sd[1]),
            *rest)


def ad_from_seeds(
    inputs: Cloudsc2Inputs, seeds: Cloudsc2StreamOutputs, checkpoints: Checkpoints,
    params: Params, *, lregcl: bool = True, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None,
) -> Cloudsc2Inputs:
    """The standard contract's AD half on levels-major inputs with pqs: the
    reverse sweep (:func:`cloudsc2_ad`) seeded with the 8 folded ``seeds``
    (:func:`seed_streams`, :func:`tl_contract`) from the carry
    ``checkpoints`` a forward sweep wrote.  Returns the levels-major input
    adjoints."""
    return cloudsc2_ad(inputs, seeds, checkpoints, params, lregcl=lregcl,
                       ldrain1d=ldrain1d, fold_seeds=False, pre=pre)


def cloudsc2_kernel_tl(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    lregcl: bool = False, ldrain1d: bool = False, levels_major: bool = False,
    pre: Optional[KernelPrelude] = None,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Outputs]:
    """Tangent-linear CLOUDSC2 through the streamed-increment sweep:
    returns (outputs, d_outputs) in the 10-field contract.

    Drop-in for :func:`cloudsc2jax_torch.tlad.cloudsc2_tl` on
    LPHYLIN=True: ``(ncol, nlev)`` inputs and increments (paph ``(ncol,
    nlev+1)``), or levels-major ones with ``levels_major``, which come back
    in the same layout.  CUDA tensors run :func:`cloudsc2_tl_din`'s kernel,
    CPU tensors its plain version; :func:`tl_contract` assembles both
    contracts in place.  ``pre`` is :func:`kernel_prelude` of the
    levels-major inputs where the caller has it."""
    if not levels_major:
        inputs, d_inputs = to_levels_major(inputs), to_levels_major(d_inputs)
    out, dout, _ = tl_contract(
        lambda slots: cloudsc2_tl_din(inputs, d_inputs, params, lregcl=lregcl,
                                      ldrain1d=ldrain1d, pre=pre, out=slots),
        inputs.pt, params, seeds=False)
    if levels_major:
        return out, dout
    return tuple(Cloudsc2Outputs(*(x.T for x in t)) for t in (out, dout))


def cloudsc2_kernel_ad(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2Outputs, params: Params, *,
    lregcl: bool = True, ldrain1d: bool = False, levels_major: bool = False,
    pre: Optional[KernelPrelude] = None,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Inputs]:
    """Adjoint CLOUDSC2 through the checkpointing forward sweep and the
    reverse sweep: returns (outputs, input_adjoints).

    Drop-in for :func:`cloudsc2jax_torch.tlad.cloudsc2_ad` on
    LPHYLIN=True, with the layouts of :func:`cloudsc2_kernel_tl`.
    ``d_outputs`` is a cotangent on the 10-field contract;
    :func:`seed_streams` folds it into the 8 seed streams, so the reverse
    sweep applies no (1 + L²) fold of its own.  The forward sweep
    (:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.cloudsc2_fwd_ckpt`)
    writes its flux rows into the contract's flux fields, which one
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.assemble_contract`
    finishes in place, and :func:`ad_from_seeds` runs the reverse sweep from
    its checkpoints.  CUDA tensors run the kernels after one
    :func:`kernel_prelude` for both (``pre`` where the caller has it), CPU
    tensors their plain versions."""
    if not levels_major:
        inputs = to_levels_major(inputs)
    seeds = seed_streams(d_outputs, params, levels_major)
    flux = flux_rows(inputs.pt)
    kw = dict(ldrain1d=ldrain1d, out=flux_slots(flux))
    if _device(inputs, "cloudsc2_kernel_ad") == "cpu":
        fwd, ckpts = cloudsc2_fwd_ckpt_reference(inputs, params, pre=pre, **kw)
    else:
        pre = kernel_prelude(inputs, params) if pre is None else pre
        fwd, ckpts = launch_cloudsc2_fwd_ckpt(inputs, pre, params, **kw)
    adj = ad_from_seeds(inputs, seeds, ckpts, params, lregcl=lregcl, ldrain1d=ldrain1d,
                        pre=pre)
    out, _ = assemble_contract(fwd, params, flux=flux)
    if levels_major:
        return out, adj
    return Cloudsc2Outputs(*(x.T for x in out)), Cloudsc2Inputs(*(x.T for x in adj))
