"""The work of the NL sweep's launch in a call of the nonlinear sweep, and
the least time a card could take for it: what ``nl_sweep_roofline_pct``
reads.

Frozen from the cell's shapes, whatever the kernel does: every stream the
launch reads counted once and every stream it writes counted once (the
kernel's re-reads and registers do not count).  The streams are those of
the launcher's argument lists (``KERNEL_STREAMS`` and ``KERNEL_OUTPUTS`` in
``cloudsc2jax_torch/kernels/cloudsc2_kernel.py``): ``nl_sweep``
(``csrc/cloudsc2_nl.cu``, pqs computed in registers) reads the 14 level
streams, paph (one row more), the prelude's ceta and zscalm (one value a
level) and ztrpaus and paph_sfc (one value a column); it writes the 8
outputs.  The launch is the same on both contracts: the standard
contract's sweep writes its flux rows into the contract's fields.

Operations: the configuration's ``ops_per_column_level`` (363, the
reference's NL level body with its SATUR), the whole call's, which is the
sweep's.  The peaks are ``benchmark/roofline.py``'s.
"""

from __future__ import annotations

from . import roofline

# level streams of (nlev, ncol) values, each counted once
_LEVEL_STREAMS = 14  # paph, with one row more, apart
_OUTPUTS = 8


def values(config: dict):
    """(values read, values written) by the NL sweep's launch in a call of
    the configuration ``config`` (its ``unit`` ``nl``)."""
    if config["unit"] != "nl":
        raise ValueError("nl_sweep: the nonlinear sweep's configurations only")
    nlev, ncol = config["klev"], config["ngptot"]
    read = (_LEVEL_STREAMS * nlev + nlev + 1) * ncol
    prelude = 2 * nlev + 2 * ncol  # ceta, zscalm; ztrpaus, paph_sfc
    return read + prelude, _OUTPUTS * nlev * ncol


def sweep_work(config: dict):
    """(bytes, operations) of the NL sweep's launch in a call."""
    read, written = values(config)
    ops = config["ops_per_column_level"] * config["klev"] * config["ngptot"]
    return (read + written) * roofline.ITEMSIZE[config["dtype"]], ops


def least_time_s(config: dict) -> float:
    """The larger of the launch's bytes at the card's peak bandwidth and its
    operations at the dtype's peak rate."""
    nbytes, ops = sweep_work(config)
    return max(nbytes / roofline.PEAK_BYTES_PER_S, ops / roofline.PEAK_FLOPS[config["dtype"]])
