"""The work of each hand-written sweep a call of the TL+AD unit launches on
the stream contract, and the least time a card could take for it: what
``tl_sweep_roofline_pct`` and ``ad_sweep_roofline_pct`` read.

Frozen from the cell's shapes, whatever the kernel does: every stream the
launch reads counted once and every stream it writes counted once (the
kernels' re-reads, registers and shared memory do not count).  The
streams are those of the launchers' argument lists (``TL_STREAMS``,
``TL_OUTPUTS``, ``AD_STREAMS``, ``AD_OUTPUTS`` in
``cloudsc2jax_torch/kernels/tlad_kernel.py``):

* ``tl_sweep`` (``csrc/cloudsc2_tl.cu``, increments in registers) reads
  the 16 inputs and the prelude's ztrpaus and paph_sfc (one value a
  column) and ceta and zscalm (one value a level); it writes the 8
  tangents and the 3 carry checkpoints, and with ``write_primal`` the 8
  primal streams;
* ``ad_sweep`` (``csrc/cloudsc2_ad.cu``) reads the 16 inputs, the
  prelude's four, the 3 checkpoints and the 8 seeds (27 level streams),
  and writes the 16 adjoints.

Operations: the pointwise operations a sweep's own part of the reference's
unit performs per column and level, counted by :func:`count_ops` and frozen
in :data:`OPS_PER_COLUMN_LEVEL`: those of ``torch.func.jvp`` of the
scheme for the TL, of ``torch.func.vjp`` (its primal recompute and its
transpose) for the AD.  The peaks are ``benchmark/roofline.py``'s.
"""

from __future__ import annotations

from . import roofline

SWEEPS = ("tl_sweep", "ad_sweep")
# count_ops() of the reference at 137 levels, rounded (torch 2.13)
OPS_PER_COLUMN_LEVEL = {"tl_sweep": 899, "ad_sweep": 948}
# level streams of (nlev, ncol) values, each counted once
_INPUTS = 16  # paph has one row more
_TANGENTS = _SEEDS = _PRIMAL = 8
_CHECKPOINTS = 3


def values(sweep: str, config: dict, traffic: dict):
    """(values read, values written) by one launch of ``sweep`` in a call of
    the cell ``config`` x ``traffic`` (the stream contract only)."""
    if config["unit"] != "tlad" or traffic["contract"] != "stream":
        raise ValueError(f"{sweep}: the stream contract of the TL+AD unit only")
    nlev, ncol = config["klev"], config["ngptot"]
    inputs = _INPUTS * nlev + 1
    prelude = 2 * ncol + 2 * nlev  # ztrpaus, paph_sfc; ceta, zscalm
    if sweep == "tl_sweep":
        out = _TANGENTS + _CHECKPOINTS + (_PRIMAL if traffic.get("write_primal", True) else 0)
        return inputs * ncol + prelude, out * nlev * ncol
    if sweep == "ad_sweep":
        read = inputs * ncol + prelude + (_CHECKPOINTS + _SEEDS) * nlev * ncol
        return read, inputs * ncol
    raise ValueError(f"no sweep {sweep!r}: one of {SWEEPS}")


def sweep_work(sweep: str, config: dict, traffic: dict):
    """(bytes, operations) of one launch of ``sweep`` in a call."""
    read, written = values(sweep, config, traffic)
    ops = OPS_PER_COLUMN_LEVEL[sweep] * config["klev"] * config["ngptot"]
    return (read + written) * roofline.ITEMSIZE[config["dtype"]], ops


def least_time_s(sweep: str, config: dict, traffic: dict) -> float:
    """The larger of the launch's bytes at the card's peak bandwidth and its
    operations at the dtype's peak rate."""
    nbytes, ops = sweep_work(sweep, config, traffic)
    return max(nbytes / roofline.PEAK_BYTES_PER_S, ops / roofline.PEAK_FLOPS[config["dtype"]])


def count_ops(nlon: int = 5, nlev: int = 137, seed: int = 1) -> dict:
    """Per sweep, the pointwise operations per column and level of its part
    of the reference's unit, on ``nlon`` seeded float64 columns: the output
    elements of every pointwise ATen operation whose output is one row of
    the columns (one value a column: a level's values, or a column's), over
    ``nlon * nlev``.  Whole-field operations of the reference's own layout
    (the increments, stacking the levels, accumulating the cotangents of a
    level's slices) are the driver's, not a sweep's, and do not count.  Not
    part of a run."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from . import data
    from .reference import physics

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor)
                    and out.numel() == nlon):
                self.n += nlon
            return out

    c = physics.consts(3600.0)
    stored = data.make_sets(seed, 1, nlon=nlon, nlev=nlev, c=c, dtype=torch.float64,
                            pqs=True)[0]
    x = tuple(v.T for v in stored.values())
    ceta = data.ceta(stored)

    def scheme(*fields):
        out = physics.cloudsc2(dict(zip(stored, fields)), ceta, c, lregcl=True)
        return tuple(out[k] for k in physics.OUTPUTS)

    dx = tuple(0.01 * v for v in x)
    with Count() as tl:
        _, dout = torch.func.jvp(scheme, x, dx)
    with Count() as ad:
        torch.func.vjp(scheme, *x)[1](dout)
    return {"tl_sweep": tl.n / (nlon * nlev), "ad_sweep": ad.n / (nlon * nlev)}
