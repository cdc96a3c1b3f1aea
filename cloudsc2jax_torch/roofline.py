"""The least time the card could take for each kernel's work: its roofline.

Port of ``tools/roofline.py`` for the hand-written kernels of the port::

    python -m cloudsc2jax_torch.roofline [KERNEL ...] [--ncol N] [--nlev L]
        [--dtype float32|float64] [--ms MS] [--ceiling-gbps GBPS]
        [--bytes-per-s B] [--f32-flops F] [--f64-flops F]

prints one JSON line per kernel (all of :data:`KERNELS` without names).
Each kernel is described by what one call must move and compute, whatever
implements it: the level rows it reads and writes per level in the working
dtype (and, for the encoded sweeps, in 16 bits), the rows beyond the levels
(paph's surface row), the prelude it reads (ceta and zscalm per level, the
tropopause eta and the surface pressure per column), the encoding's decode
table, and its operations per level and column (302 for the hand-written NL
body, the reference's ~292 flops and ~10 transcendentals; for the TL and AD
bodies the statement counts that the generated headers
``csrc/cloudsc2_{tl,ad}_level.cuh`` state).  Every input is counted read
once and every output written once.

The bound is the larger of the bytes over the card's memory rate and the
operations over its rate for the dtype, by default the published ceilings
of an NVIDIA H100 SXM (3.35 TB/s, 67 TFLOP/s f32 and 34 TFLOP/s f64 outside
the tensor cores; the flags override them).  With ``--ms`` the line adds
the attained GB/s and the share of the bound; with ``--ceiling-gbps`` (the
window-matched rate of ``python -m cloudsc2jax_torch.bw_probe`` at the
kernel's mix) the time that ceiling gives for the kernel's bytes and the
share of it.  ``chip_smoke.py`` takes every kernel's bound from here and
holds these bytes to those of the tensors its run moves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
from typing import Optional, Tuple

__all__ = ["KERNELS", "PEAK_BYTES_PER_S", "PEAK_FLOP_PER_S", "Traffic", "bound",
           "bound_of", "level_statements", "nbytes", "operations", "report"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

# NVIDIA H100 SXM data sheet: the device memory rate and the rates outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
# operations of the hand-written NL level body per level and column: ~292
# flops and ~10 transcendentals (the count the reference's cost estimate of
# the same body uses, cloudsc2jax/pallas/tlad_kernel.py:704-707)
NL_OPS_PER_LEVEL_COLUMN = 302
# the encodings' decode table: (nlev + 1) levels of 16 [scale, offset] f32
# pairs (kernels.experiments: enc and its level-major copy, levels)
TABLE_PAIRS = 16


@dataclasses.dataclass(frozen=True)
class Traffic:
    """What one call of a kernel moves and computes, per column.

    ``reads``/``writes`` are level rows in the working dtype,
    ``reads16`` level rows of a 16-bit payload, ``read_extra``/
    ``write_extra`` rows beyond the levels (paph and its adjoint have
    nlev+1), ``prelude`` the kernel prelude's 2·nlev + 2·ncol values,
    ``table`` the encoding's decode table.  ``ops`` is ``("nl",)``,
    ``("probe", writes)`` or a tuple of ``(kind, evap, lregcl)`` level bodies
    whose statements count."""

    reads: int
    writes: int
    read_extra: int = 0
    write_extra: int = 0
    reads16: int = 0
    prelude: bool = True
    table: bool = False
    ops: Tuple = ("nl",)


# the kernels of PERF.md section 6, by the name of their launch counter
KERNELS = {
    # 14 level fields and paph in (qsat computed), 8 streams out
    "cloudsc2_nl": Traffic(reads=15, read_extra=1, writes=8),
    # the same with pqs read, staged through shared memory
    "cloudsc2_nl_res": Traffic(reads=16, read_extra=1, writes=8),
    # the default encoding (pq, plu, paph kept f32): 12 int16 rows
    "cloudsc2_nl_enc": Traffic(reads16=12, reads=3, read_extra=1, writes=8,
                               table=True),
    # pqs read; 8 streams and the 3 carry checkpoints out
    "cloudsc2_fwd_ckpt": Traffic(reads=16, read_extra=1, writes=11),
    # increments in registers: 8 primal, 8 tangent, 3 checkpoints out
    "cloudsc2_tl": Traffic(reads=16, read_extra=1, writes=19,
                           ops=(("tl", False, True),)),
    # the 16 tangent streams read too; 8 primal and 8 tangent out
    "cloudsc2_tl_din": Traffic(reads=32, read_extra=2, writes=16,
                               ops=(("tl", False, False),)),
    # inputs, 8 tangent seeds and 3 checkpoints in; the 16 adjoints out
    "cloudsc2_ad": Traffic(reads=27, read_extra=1, writes=16, write_extra=1,
                           ops=(("ad", False, True),)),
    # inputs once; primal, tangent and adjoints out
    "cloudsc2_tlad_fused": Traffic(reads=16, read_extra=1, writes=32, write_extra=1,
                                   ops=(("tl", False, True), ("ad", False, True))),
    # the default encoding (pq, plu, paph kept f32): 13 int16 rows
    "cloudsc2_tl_enc": Traffic(reads16=13, reads=3, read_extra=1, writes=19,
                               table=True, ops=(("tl", False, True),)),
    "cloudsc2_ad_enc": Traffic(reads16=13, reads=14, read_extra=1, writes=16,
                               write_extra=1, table=True,
                               ops=(("ad", False, True),)),
    # the window probe at the NL mix: 15 reads, 8 writes of a + s*b
    "bw_probe": Traffic(reads=15, writes=8, prelude=False, ops=("probe", 8)),
    # the 17-stream adjoint convention: each level's 17 cotangents at its
    # own slot and the surface row's sum, where the in-place kernel writes
    # 16 rows a level and paph's surface row
    "cloudsc2_ad_xscat": Traffic(reads=27, read_extra=1, writes=17, write_extra=1,
                                 ops=(("ad", False, True),)),
}
# the schedules that move what another kernel moves: C levels a step (the
# bytes of one level a step: the same streams, each read and written once)
# and the bfloat16 payloads (the int16 payloads' bytes)
KERNELS.update({
    "cloudsc2_fwd_chunk": KERNELS["cloudsc2_fwd_ckpt"],
    "cloudsc2_tl_chunk": KERNELS["cloudsc2_tl"],
    # the standard contract's TL: cloudsc2_tl's uncontracted build, primal written
    "cloudsc2_tl_std": KERNELS["cloudsc2_tl"],
    "cloudsc2_tl_din_chunk": KERNELS["cloudsc2_tl_din"],
    "cloudsc2_ad_chunk": KERNELS["cloudsc2_ad_xscat"],
    "cloudsc2_tl_enc_bf16": KERNELS["cloudsc2_tl_enc"],
    "cloudsc2_ad_enc_bf16": KERNELS["cloudsc2_ad_enc"],
})


def level_statements(kind: str, evap: bool, lregcl: bool) -> int:
    """Statements of one generated level body, from the header's own count."""
    text = (CSRC / f"cloudsc2_{kind}_level.cuh").read_text()
    flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
    m = re.search(rf"lregcl: {flags} \((\d+) statements", text)
    if m is None:
        raise ValueError(f"no statement count for Level<{flags}> in {kind}")
    return int(m.group(1))


def nbytes(name: str, ncol: int, nlev: int, itemsize: int = 4) -> int:
    """Bytes one call of kernel ``name`` must move."""
    t = KERNELS[name]
    rows = (t.reads + t.writes) * nlev + t.read_extra + t.write_extra
    total = rows * ncol * itemsize + t.reads16 * nlev * ncol * 2
    if t.prelude:
        total += (2 * nlev + 2 * ncol) * itemsize
    if t.table:
        total += (nlev + 1) * TABLE_PAIRS * 2 * 4
    return total


def operations(name: str, ncol: int, nlev: int) -> int:
    """Operations of one call: per level and column, times both."""
    ops = KERNELS[name].ops
    if ops[0] == "nl":
        per = NL_OPS_PER_LEVEL_COLUMN
    elif ops[0] == "probe":
        per = 3 * ops[1]  # one multiply-add and one add per output
    else:
        per = sum(level_statements(*body) for body in ops)
    return per * nlev * ncol


def bound_of(nbytes_: int, ops: float, dtype: str = "float32", *,
             bytes_per_s: float = PEAK_BYTES_PER_S,
             flop_per_s: Optional[float] = None) -> dict:
    """The least time the card could take for ``nbytes_`` and ``ops``: the
    larger of the two over their rates, and which one it is."""
    rate = PEAK_FLOP_PER_S[dtype] if flop_per_s is None else flop_per_s
    by_bytes = nbytes_ / bytes_per_s * 1e3
    by_ops = ops / rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes_, "operations": ops}


def bound(name: str, ncol: int, nlev: int, dtype: str = "float32", **rates) -> dict:
    """:func:`bound_of` of kernel ``name`` at ``ncol`` columns and ``nlev``
    levels."""
    itemsize = {"float32": 4, "float64": 8}[dtype]
    return bound_of(nbytes(name, ncol, nlev, itemsize), operations(name, ncol, nlev),
                    dtype, **rates)


def report(name: str, ncol: int, nlev: int, dtype: str = "float32", *,
           ms: Optional[float] = None, ceiling_gbps: Optional[float] = None,
           **rates) -> dict:
    """:func:`bound` with, given the kernel's ``ms``, the attained GB/s and
    the share of the bound, and given a probe's ``ceiling_gbps``, the
    ceiling's time for these bytes (and its share of ``ms``)."""
    rec = {"kernel": name, "ncol": ncol, "nlev": nlev, "dtype": dtype,
           **bound(name, ncol, nlev, dtype, **rates)}
    if ceiling_gbps is not None:
        rec["ceiling_ms"] = rec["bytes"] / (ceiling_gbps * 1e9) * 1e3
    if ms is not None:
        rec["ms"] = ms
        rec["attained_gbps"] = rec["bytes"] / (ms * 1e-3) / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / ms
        if ceiling_gbps is not None:
            rec["share_of_ceiling"] = rec["ceiling_ms"] / ms
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cloudsc2jax_torch.roofline",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", metavar="KERNEL",
                    help=f"any of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--ncol", type=int, default=327680)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--dtype", choices=list(PEAK_FLOP_PER_S), default="float32")
    ap.add_argument("--ms", type=float, default=None, help="the kernel's time")
    ap.add_argument("--ceiling-gbps", type=float, default=None,
                    help="the window-matched probe's rate at the kernel's mix")
    ap.add_argument("--bytes-per-s", type=float, default=PEAK_BYTES_PER_S)
    ap.add_argument("--f32-flops", type=float, default=PEAK_FLOP_PER_S["float32"])
    ap.add_argument("--f64-flops", type=float, default=PEAK_FLOP_PER_S["float64"])
    args = ap.parse_args(argv)
    unknown = [k for k in args.kernels if k not in KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {', '.join(KERNELS)}")
    rate = args.f32_flops if args.dtype == "float32" else args.f64_flops
    for name in args.kernels or KERNELS:
        print(json.dumps(report(name, args.ncol, args.nlev, args.dtype, ms=args.ms,
                                ceiling_gbps=args.ceiling_gbps,
                                bytes_per_s=args.bytes_per_s, flop_per_s=rate)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
