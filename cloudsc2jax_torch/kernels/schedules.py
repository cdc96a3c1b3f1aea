"""The TL and AD sweeps' other schedules: C levels a step and the 17-stream
adjoint convention.  CUDA kernels and plain versions.

Port of the schedules :mod:`cloudsc2jax.pallas.tlad_kernel` keeps beside
the one each main path runs: ``chunk_levels`` C in :data:`CHUNK_LEVELS`
(``_tl_kernel``, ``_fwd_ckpt_kernel`` and ``_rev_kernel`` with ``chunk``)
and the 17-stream convention (``cloudsc2_pallas_ad(inplace_scatter=False)``).
None of them is on a main path: on an NVIDIA H100 each loses to the
one-level, in-place schedule (PERF.md §6), so this module is to the
sweeps of :mod:`~cloudsc2jax_torch.kernels.tlad_kernel` what
:mod:`~cloudsc2jax_torch.kernels.experiments` is to the encoded and fused
ones.  :mod:`cloudsc2jax_torch.kernel_ab` times them (``xscat``,
``xscatnp``, ``chunk:<C>``) beside the two-kernel unit.

* :func:`cloudsc2_ad_xscat`: the reverse sweep under the 17-stream
  convention (``csrc/cloudsc2_ad_xscat.cu``).  The kernel writes the
  cotangents of all 17 values a level reads at that level's slot
  (:class:`ShiftedAdjoints`, :func:`launch_cloudsc2_ad_streams`) and
  :func:`assemble_shifted_adjoints` adds the shifted ones in PyTorch.
* :func:`cloudsc2_tl_chunked`, :func:`cloudsc2_tl_din_chunked`,
  :func:`cloudsc2_fwd_ckpt_chunked` and :func:`cloudsc2_ad_chunked`: C
  levels a step (``csrc/cloudsc2_tl_chunk.cu``,
  ``csrc/cloudsc2_tl_din_chunk.cu``, ``csrc/cloudsc2_fwd_chunk.cu``,
  ``csrc/cloudsc2_ad_chunk.cu``).  As in the JAX package the chunked TL
  writes the primal streams and the chunked AD runs under the 17-stream
  convention, their only ones.

Each wrapper sends CUDA tensors to its kernel, CPU tensors to its plain
version, and counts its kernel launches in ``.launches``.  The plain
versions check C as the JAX package does and run the one-level plain
versions: the results do not depend on the schedule, since every level
runs the same body on the same values in the same order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import spans
from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs
from . import build
from . import cloudsc2_kernel as km
from . import tlad_kernel as tk
from .cloudsc2_kernel import (
    FWD_CKPT_OUTPUTS,
    FWD_CKPT_STREAMS,
    KERNEL_CONSTANTS,
    Checkpoints,
    Cloudsc2StreamOutputs,
    KernelPrelude,
    _LEVEL_FIELDS,
    _check_config,
    _evap,
    kernel_prelude,
    plain_prelude,
)

__all__ = [
    "AD_SHIFTED_OUTPUTS",
    "CHUNK_LEVELS",
    "ShiftedAdjoints",
    "assemble_shifted_adjoints",
    "check_chunk_levels",
    "cloudsc2_ad_chunked",
    "cloudsc2_ad_chunked_reference",
    "cloudsc2_ad_streams_reference",
    "cloudsc2_ad_xscat",
    "cloudsc2_ad_xscat_reference",
    "cloudsc2_fwd_ckpt_chunked",
    "cloudsc2_fwd_ckpt_chunked_reference",
    "cloudsc2_tl_chunked",
    "cloudsc2_tl_chunked_reference",
    "cloudsc2_tl_din_chunked",
    "cloudsc2_tl_din_chunked_reference",
    "launch_cloudsc2_ad_streams",
    "launch_cloudsc2_fwd_ckpt_chunked",
    "launch_cloudsc2_tl_chunked",
    "launch_cloudsc2_tl_din_chunked",
]

# the levels a step the chunked libraries are built for (the cases of their
# launchers' switch in csrc/cloudsc2_{fwd,ad}_chunk.cu and
# cloudsc2_tl_sweep.cuh): the JAX tests' 2 and 3 and the JAX harness's
# example 4
CHUNK_LEVELS = (2, 3, 4)
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


def check_chunk_levels(chunk_levels: int) -> int:
    """``chunk_levels`` as an int; raises ``ValueError`` unless it is one of
    the built :data:`CHUNK_LEVELS`, on any device."""
    if chunk_levels not in CHUNK_LEVELS:
        raise ValueError(f"chunk_levels must be one of the built "
                         f"{', '.join(map(str, CHUNK_LEVELS))}, got {chunk_levels!r}")
    return int(chunk_levels)


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
@spans.spanned("ad_sweep")
def cloudsc2_ad_streams_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
) -> ShiftedAdjoints:
    """Plain reverse sweep under the 17-stream convention, on any device:
    the :class:`ShiftedAdjoints` of :func:`~cloudsc2jax_torch.kernels.
    tlad_kernel.cloudsc2_ad_reference`'s loop, each level's 17 cotangents
    stored at its own slot and the paph_sfc cotangents summed over the
    levels in the same order."""
    _check_config(params, ldrain1d)
    tk._need_pqs(inputs)
    pre = plain_prelude(inputs, params) if pre is None else pre
    nlev = inputs.pt.shape[0]
    srfl, ssfl = tk.seed_scales(params) if fold_seeds else (1.0, 1.0)
    zero = torch.zeros_like(inputs.pt[0])
    dcarry = (zero, zero, zero)
    dsfc = zero
    cols = (pre.ztrpaus, pre.paph_sfc)
    streams = [torch.empty_like(inputs.pt) for _ in range(len(_LEVEL_FIELDS) + 3)]
    for k in reversed(range(nlev)):
        carry_in = tuple(c[k] for c in checkpoints)
        _, vjp_fn = torch.func.vjp(
            tk._level_fn(params, ldrain1d, lregcl, pre, k, nlev),
            tk._level_fields(inputs, k, nlev), cols, carry_in)
        seeds = tuple(s[k] for s in d_outputs)
        seeds = seeds[:6] + (seeds[6] * srfl, seeds[7] * ssfl)
        dfields, dcols, dcarry = vjp_fn((seeds, dcarry))
        for buf, v in zip(streams, dfields):
            buf[k] = v
        dsfc = dsfc + dcols[1]
    return ShiftedAdjoints(*streams, dsfc)


def cloudsc2_ad_xscat_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
) -> Cloudsc2Inputs:
    """Plain version of :func:`cloudsc2_ad_xscat`: the 17 streams of
    :func:`cloudsc2_ad_streams_reference` assembled by
    :func:`assemble_shifted_adjoints`, the in-place plain AD's adjoints bit
    for bit."""
    return _assembled(cloudsc2_ad_streams_reference(
        inputs, d_outputs, checkpoints, params, lregcl=lregcl, ldrain1d=ldrain1d,
        fold_seeds=fold_seeds, pre=pre))


def cloudsc2_ad_chunked_reference(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, chunk_levels: int,
    lregcl: bool = True, ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
) -> Cloudsc2Inputs:
    """Plain version of :func:`cloudsc2_ad_chunked`: ``chunk_levels``
    checked, then :func:`cloudsc2_ad_xscat_reference`."""
    check_chunk_levels(chunk_levels)
    return cloudsc2_ad_xscat_reference(
        inputs, d_outputs, checkpoints, params, lregcl=lregcl, ldrain1d=ldrain1d,
        fold_seeds=fold_seeds, pre=pre)


def cloudsc2_tl_chunked_reference(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float, chunk_levels: int,
    lregcl: bool = True, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None,
):
    """Plain version of :func:`cloudsc2_tl_chunked`: ``chunk_levels``
    checked, then :func:`~cloudsc2jax_torch.kernels.tlad_kernel.
    cloudsc2_tl_reference` with the primal streams."""
    check_chunk_levels(chunk_levels)
    return tk.cloudsc2_tl_reference(inputs, params, dscale=dscale, lregcl=lregcl,
                                    ldrain1d=ldrain1d, pre=pre)


def cloudsc2_tl_din_chunked_reference(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    chunk_levels: int, lregcl: bool = False, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """Plain version of :func:`cloudsc2_tl_din_chunked`: ``chunk_levels``
    checked, then the streamed-increment plain TL sweep."""
    check_chunk_levels(chunk_levels)
    out, dout, _ = tk.cloudsc2_tl_reference(inputs, params, d_inputs=d_inputs,
                                            lregcl=lregcl, ldrain1d=ldrain1d,
                                            pre=pre, out=out)
    return out, dout


def cloudsc2_fwd_ckpt_chunked_reference(
    inputs: Cloudsc2Inputs, params: Params, *, chunk_levels: int,
    ldrain1d: bool = False, pre: Optional[KernelPrelude] = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """Plain version of :func:`cloudsc2_fwd_ckpt_chunked`: ``chunk_levels``
    checked, then :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.
    cloudsc2_fwd_ckpt_reference`."""
    check_chunk_levels(chunk_levels)
    return km.cloudsc2_fwd_ckpt_reference(inputs, params, ldrain1d=ldrain1d,
                                          pre=pre, out=out)


# -------------------------------------------------------------- CUDA kernels
# the TL/AD family's libraries here: their pointer arrays, then their scalar
# arguments between the params array and the stream (the chunked ones as
# their one-level twins, then chunk)
_LAYOUT = {
    "cloudsc2_ad_xscat": (
        (tk.AD_STREAMS, AD_SHIFTED_OUTPUTS),
        [ctypes.c_double] * 2 + [ctypes.c_int] * 4),  # seed scales; ncol nlev evap lregcl
    "cloudsc2_tl_chunk": (
        (tk.TL_STREAMS, tk.TL_OUTPUTS),
        [ctypes.c_double] + [ctypes.c_int] * 5),  # dscale; ncol nlev evap lregcl chunk
    "cloudsc2_tl_din_chunk": (
        (tk.TL_STREAMS, tk.TL_TANGENT_STREAMS, tk.TL_OUTPUTS),
        [ctypes.c_int] * 5),  # ncol nlev evap lregcl chunk
    "cloudsc2_ad_chunk": (
        (tk.AD_STREAMS, AD_SHIFTED_OUTPUTS),
        [ctypes.c_double] * 2 + [ctypes.c_int] * 5),  # seed scales; ncol nlev evap lregcl chunk
}
_BINDINGS = {name: tk._binding(name, layout) for name, layout in _LAYOUT.items()}


def _library(name: str):
    return build.bind(name, **_BINDINGS[name])


def _load_fwd_chunk():
    argtypes = km._NL_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]  # chunk
    return build.bind(
        "cloudsc2_fwd_chunk",
        {"cloudsc2_fwd_chunk_abi": (len(FWD_CKPT_STREAMS), len(FWD_CKPT_OUTPUTS),
                                    len(KERNEL_CONSTANTS))},
        {"cloudsc2_fwd_chunk_f32": argtypes, "cloudsc2_fwd_chunk_f64": argtypes})


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
    ``cloudsc2_ad_xscat.launches``; ``chunk_levels`` C, one of
    :data:`CHUNK_LEVELS`, runs ``csrc/cloudsc2_ad_chunk.cu`` and counts in
    ``cloudsc2_ad_chunked.launches``.  Checks as
    :func:`~cloudsc2jax_torch.kernels.tlad_kernel.launch_cloudsc2_ad`."""
    if chunk_levels != 1:
        chunk_levels = check_chunk_levels(chunk_levels)
    tk._check_launch(inputs, params, ldrain1d, "launch_cloudsc2_ad_streams")
    streams = tk._ad_operands(inputs, pre, d_outputs, checkpoints, "cloudsc2_ad")
    nlev, ncol = inputs.pt.shape
    name = "cloudsc2_ad_xscat" if chunk_levels == 1 else "cloudsc2_ad_chunk"
    lib = _library(name)
    outs = [torch.empty_like(inputs.pt) for _ in range(len(_LEVEL_FIELDS) + 3)]
    outs.append(torch.empty_like(inputs.pt[0]))
    scales = tk.seed_scales(params) if fold_seeds else (1.0, 1.0)
    build.launch(lib, name, inputs.pt, streams, outs,
                 tk._param_array(lib, name, params), *scales, ncol, nlev,
                 int(_evap(params, ldrain1d)), int(lregcl),
                 *(() if chunk_levels == 1 else (chunk_levels,)))
    if chunk_levels == 1:
        cloudsc2_ad_xscat.launches += 1
    else:
        cloudsc2_ad_chunked.launches += 1
    return ShiftedAdjoints(*outs)


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl_chunked(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    dscale: float, chunk_levels: int, ldrain1d: bool = False, lregcl: bool = True,
):
    """Launch the chunked TL kernel (``csrc/cloudsc2_tl_chunk.cu``) on CUDA
    tensors, on the current stream: returns (outputs, tangents,
    checkpoints), the primal streams written.  Checks as
    :func:`~cloudsc2jax_torch.kernels.tlad_kernel.launch_cloudsc2_tl`; counts
    each launch in ``cloudsc2_tl_chunked.launches``."""
    chunk_levels = check_chunk_levels(chunk_levels)
    outs = tk._tl_launch("cloudsc2_tl_chunk", _library, inputs, pre, params,
                         dscale=dscale, ldrain1d=ldrain1d, lregcl=lregcl,
                         write_primal=True, extra=(chunk_levels,))
    cloudsc2_tl_chunked.launches += 1
    return outs


@spans.spanned("tl_sweep")
def launch_cloudsc2_tl_din_chunked(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, pre: KernelPrelude,
    params: Params, *, chunk_levels: int, ldrain1d: bool = False,
    lregcl: bool = False, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """Launch the chunked streamed-increment TL kernel
    (``csrc/cloudsc2_tl_din_chunk.cu``) on CUDA tensors, on the current
    stream: returns (outputs, tangents).  Checks and ``out`` as
    :func:`~cloudsc2jax_torch.kernels.tlad_kernel.launch_cloudsc2_tl_din`;
    counts each launch in ``cloudsc2_tl_din_chunked.launches``."""
    chunk_levels = check_chunk_levels(chunk_levels)
    outs = tk._tl_din_launch("cloudsc2_tl_din_chunk", _library, inputs, d_inputs,
                             pre, params, ldrain1d=ldrain1d, lregcl=lregcl, out=out,
                             extra=(chunk_levels,))
    cloudsc2_tl_din_chunked.launches += 1
    return outs


@spans.spanned("fwd_sweep")
def launch_cloudsc2_fwd_ckpt_chunked(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    chunk_levels: int, ldrain1d: bool = False, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """Launch the chunked checkpointing forward kernel
    (``csrc/cloudsc2_fwd_chunk.cu``) on CUDA tensors, on the current
    stream: ``(outputs, checkpoints)``.  Checks and ``out`` as
    :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.launch_cloudsc2_fwd_ckpt`;
    counts each launch in ``cloudsc2_fwd_ckpt_chunked.launches``."""
    chunk_levels = check_chunk_levels(chunk_levels)
    if inputs.pqs is None:
        raise ValueError("the checkpointing forward sweep reads pqs")
    outs = km._launch("cloudsc2_fwd_chunk", FWD_CKPT_STREAMS, FWD_CKPT_OUTPUTS,
                      inputs, pre, params, ldrain1d, library=_load_fwd_chunk,
                      extra=(chunk_levels,), out=out)
    cloudsc2_fwd_ckpt_chunked.launches += 1
    return Cloudsc2StreamOutputs(*outs[:8]), tuple(outs[8:])


# ------------------------------------------------------------------ wrappers
def cloudsc2_ad_xscat(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, lregcl: bool = True,
    ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
) -> Cloudsc2Inputs:
    """The reverse sweep under the 17-stream convention
    (``cloudsc2_pallas_ad(inplace_scatter=False)``): the input adjoints of
    :func:`~cloudsc2jax_torch.kernels.tlad_kernel.cloudsc2_ad`, levels-major.

    CUDA tensors run :func:`launch_cloudsc2_ad_streams` and
    :func:`assemble_shifted_adjoints`; CPU tensors run the plain version
    :func:`cloudsc2_ad_xscat_reference`; any other device raises."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=fold_seeds)
    if tk._device(inputs, "cloudsc2_ad_xscat") == "cpu":
        return cloudsc2_ad_xscat_reference(inputs, d_outputs, checkpoints, params,
                                           pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return _assembled(launch_cloudsc2_ad_streams(inputs, pre, d_outputs, checkpoints,
                                                 params, **kw))


def cloudsc2_ad_chunked(
    inputs: Cloudsc2Inputs, d_outputs: Cloudsc2StreamOutputs,
    checkpoints: Checkpoints, params: Params, *, chunk_levels: int,
    lregcl: bool = True, ldrain1d: bool = False, fold_seeds: bool = True,
    pre: Optional[KernelPrelude] = None,
) -> Cloudsc2Inputs:
    """The reverse sweep ``chunk_levels`` C levels a step
    (``cloudsc2_pallas_ad(chunk_levels=C)``), under the 17-stream
    convention: the input adjoints, levels-major.

    CUDA tensors run :func:`launch_cloudsc2_ad_streams` at C and
    :func:`assemble_shifted_adjoints`; CPU tensors run the plain version
    :func:`cloudsc2_ad_chunked_reference`; any other device raises."""
    kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, fold_seeds=fold_seeds)
    if tk._device(inputs, "cloudsc2_ad_chunked") == "cpu":
        return cloudsc2_ad_chunked_reference(inputs, d_outputs, checkpoints, params,
                                             chunk_levels=chunk_levels, pre=pre, **kw)
    chunk_levels = check_chunk_levels(chunk_levels)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return _assembled(launch_cloudsc2_ad_streams(inputs, pre, d_outputs, checkpoints,
                                                 params, chunk_levels=chunk_levels,
                                                 **kw))


def cloudsc2_tl_chunked(
    inputs: Cloudsc2Inputs, params: Params, *, dscale: float, chunk_levels: int,
    lregcl: bool = True, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None,
):
    """The TL sweep with in-register increments ``dscale·x``, ``chunk_levels``
    C levels a step (``cloudsc2_pallas_tl(chunk_levels=C)``): returns
    (outputs, tangents, checkpoints), the primal streams written.

    CUDA tensors run :func:`launch_cloudsc2_tl_chunked`; CPU tensors run the
    plain version :func:`cloudsc2_tl_chunked_reference`; any other device
    raises."""
    kw = dict(dscale=dscale, chunk_levels=chunk_levels, lregcl=lregcl,
              ldrain1d=ldrain1d)
    if tk._device(inputs, "cloudsc2_tl_chunked") == "cpu":
        return cloudsc2_tl_chunked_reference(inputs, params, pre=pre, **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl_chunked(inputs, pre, params, **kw)


def cloudsc2_tl_din_chunked(
    inputs: Cloudsc2Inputs, d_inputs: Cloudsc2Inputs, params: Params, *,
    chunk_levels: int, lregcl: bool = False, ldrain1d: bool = False,
    pre: Optional[KernelPrelude] = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Cloudsc2StreamOutputs]:
    """The TL sweep with streamed increments, ``chunk_levels`` C levels a
    step: returns (outputs, tangents), 8 streams each.

    CUDA tensors run :func:`launch_cloudsc2_tl_din_chunked`; CPU tensors
    run the plain version :func:`cloudsc2_tl_din_chunked_reference`; any
    other device raises.  Both write the outputs ``out`` gives by name into
    those tensors."""
    kw = dict(chunk_levels=chunk_levels, lregcl=lregcl, ldrain1d=ldrain1d, out=out)
    if tk._device(inputs, "cloudsc2_tl_din_chunked") == "cpu":
        return cloudsc2_tl_din_chunked_reference(inputs, d_inputs, params, pre=pre,
                                                 **kw)
    pre = kernel_prelude(inputs, params) if pre is None else pre
    return launch_cloudsc2_tl_din_chunked(inputs, d_inputs, pre, params, **kw)


def cloudsc2_fwd_ckpt_chunked(
    inputs: Cloudsc2Inputs, params: Params, *, chunk_levels: int,
    ldrain1d: bool = False, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """The checkpointing forward sweep on levels-major inputs with pqs,
    ``chunk_levels`` C levels a step: ``(outputs, checkpoints)``.

    CUDA tensors run :func:`launch_cloudsc2_fwd_ckpt_chunked` (after
    :func:`kernel_prelude`); CPU tensors run the plain version
    :func:`cloudsc2_fwd_ckpt_chunked_reference`; any other device raises."""
    kw = dict(chunk_levels=chunk_levels, ldrain1d=ldrain1d, out=out)
    if tk._device(inputs, "cloudsc2_fwd_ckpt_chunked") == "cpu":
        return cloudsc2_fwd_ckpt_chunked_reference(inputs, params, **kw)
    return launch_cloudsc2_fwd_ckpt_chunked(inputs, kernel_prelude(inputs, params),
                                            params, **kw)


cloudsc2_ad_xscat.launches = 0
cloudsc2_ad_chunked.launches = 0
cloudsc2_tl_chunked.launches = 0
cloudsc2_tl_din_chunked.launches = 0
cloudsc2_fwd_ckpt_chunked.launches = 0
