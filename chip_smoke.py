#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: the
nonlinear sweep, the TL+AD work unit, the standalone TL and AD variants
(Taylor test, adjoint test, f32 verdicts through the kernels), the
``kernel_ab`` harness over the work unit's schedules (two-kernel, fused,
int16-encoded), and the NL-side experiments (the encoded and the resident
NL sweeps, the window-matched bandwidth probe ``bw_probe`` and the
``encoding_study``).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Card: a CUDA device must be present; print its name and power limit.
2. Build: compile ``cloudsc2jax_torch/csrc/cloudsc2_{nl,tl,tl_din,ad,
   tl_enc,ad_enc,tlad_fused,nl_enc,nl_res}.cu`` and ``bw_probe.cu`` (one
   build per probe mix of phase 16) with nvcc from the checkout's sources,
   all builds started together; print the build time and ptxas' registers
   and spills per kernel entry.
3. NL kernel against its plain PyTorch version on the card, on the same
   inputs: the 100-column fixture and a ragged 5,000-column expansion,
   f32 and f64, ldrain1d off and on; then the main path's own shapes
   (163,840 columns f32 and 16,384 f64, ldrain1d off) on inputs built by
   ``Cloudsc2State.device_kernel_inputs`` as the CLI builds them; max
   |kernel - plain| over the field's max |plain| within 1e-12 (f64) and
   5e-6 (f32).
4. Main path through the CLI entry point on ``cuda``:
   ``nl 1 163840 128 --dtype f32 --threshold 10000 --kernels`` and
   ``nl 1 16384 128 --dtype f64 --kernels``, both validating against the
   golden file (the stream contract, assembled once after the timed loop);
   the kernel's launch counter, zeroed just before, must show that both
   ran through the kernel; then ``nl 1 16384 128 --dtype f64``, the truth
   path, against the same golden file.
5. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the kernel, the pre-kernel PyTorch work, the whole ``run_nl`` call on
   the stream contract, the output contract's assembly (``unblock_outputs``,
   paid once where a caller validates), ``run_nl(backend="kernels")`` on
   transposed views, and the plain version, with the bytes the sweep must
   move and the attained bandwidth.
6. TL and AD kernels against their plain versions on the card: 100 and a
   ragged 5,000 columns, f32 and f64, ldrain1d off and on, the TL kernel
   with and without its primal streams; then the TL+AD path's own shapes
   (163,840 columns f32, 16,384 f64) on inputs built by
   ``device_kernel_inputs(..., pqs=True)``; within 1e-11 (f64) and, f32,
   1e-5 (TL) and 1e-4 (AD, whose plu adjoint carries f32 rounding of that
   size: PERF.md).
7. TL+AD main path through the CLI entry point on ``cuda``:
   ``tlad 1 163840 128 --dtype f32`` and ``tlad 1 16384 128 --dtype f64``,
   each passing the adjoint identity within the JAX package's budgets; both
   kernels' launch counters, zeroed just before, must show that they ran.
8. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the TL kernel with and without primal streams, the AD kernel, the whole
   ``run_tlad`` call and the plain unit (one call, not warmed up, as for
   every plain version from here on), with each kernel's bytes and attained
   bandwidth.

9. The checkpointing forward kernel and the streamed-increment TL kernel
   against their plain versions on the card: 100 and a ragged 5,000
   columns, f32 and f64, ldrain1d off and on, the TL with lregcl off and
   on, pqs perturbed by up to 1% away from SATUR in the ragged f64 cases; the
   AD kernel with lregcl off and unfolded seeds likewise; the forward
   kernel against the TL kernel's own checkpoints and primal streams; then
   the standalone paths' shapes (163,840 columns f32, 16,384 f64).
   Tolerances as in 3 and 6.
10. The standalone TL and AD paths through the CLI entry point on
   ``cuda``: ``tl 1 16384 128 --dtype f64 --kernels`` (Taylor test on the
   truth path, then the f32 parity of the TL kernel) and ``ad 1 16384 128
   --dtype f64 --kernels`` (adjoint test, then the f32 identity through the
   kernels), and ``measure_f32_verdicts`` at 163,840 f32 columns; the launch
   counters of the forward, streamed-TL and AD kernels, zeroed just before,
   must show that each ran.  Also printed: how far the TL kernel and the
   truth path, both f32, sit from the truth path in f64; and the JAX
   package's f32 TL parity, 1e-6, held by the streamed-increment TL kernel
   built with ``-fmad=false`` (the shipped build contracts multiply-adds and
   is held to 1e-5), at 16,384 columns with ``lregcl`` off and on.
11. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the forward kernel, the streamed-increment TL kernel, the
   standard-contract ``run_tlad`` on ``(ncol, nlev)``-contiguous inputs
   (with its transposes) and on transposed views of levels-major inputs
   (without), and the plain versions once.
12. The encoded TL kernel, the encoded AD kernel and the fused TL+AD kernel
   against their plain versions on the card, f32: 100 columns with
   ldrain1d off and on, a ragged 5,000, and an odd 5,001 (int16 rows then
   start on odd half-words) with ldrain1d on, the encoded TL with and
   without its primal streams; the fused kernel also in f64 (100 columns
   with ldrain1d on, 5,001 with it off); then the harness's own shape,
   163,840 f32 columns (16,384 f64 for the fused kernel).  Tolerances as in
   6.  The fused kernel is also held against the two-kernel unit on the
   same inputs, and the adjoint identity is checked through the encoded
   pair (with dx = DSCALE x the decoded inputs) and through the fused unit.
13. The harness as its users run it: ``kernel_ab.main(["two", "noprim",
   "fused", "enc", "encnp", "two"])`` at 327,680 f32 columns; the launch
   counters of the TL, AD, fused, encoded TL and encoded AD kernels, zeroed
   just before, must equal the units each config ran (warm-up and reps).
14. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the fused kernel, the encoded TL kernel with and without primal
   streams, the encoded AD kernel, each with its bytes and attained
   bandwidth, and the plain versions once.

15. The encoded NL kernel, the resident NL kernel against their plain
   versions on the card.  Encoded (f32): 100 columns with every combination
   of ``fuse_satur``, ``keep_f32`` (default, ``("pq",)``, all names, none) and
   payload (int16, bfloat16); then 100 columns with ldrain1d on, a ragged
   5,000, an odd 5,001 with ldrain1d on and 163,840 columns over six of the
   combinations; 2e-5 of the field's max against the plain version on the
   decoded trajectory (``ENC_NL_TOLERANCE`` says why), 5e-6 (and, printed,
   whether bit for bit) against the exact kernel launched on the same decoded
   inputs, and, printed, the distance to the exact sweep by the JAX test's
   metric (sum|a-b|/sum|b|, below 5e-4 for int16).  Resident: 100
   columns f32 and f64 with ldrain1d off and on, 5,000 f32, 5,001 f64, at
   the default ring, at a ring whose depth does not divide the levels, and
   with every level on chip first (``depth = nlev`` at the widest block
   that fits); then 163,840 f32 and 16,384 f64; 5e-6 / 1e-12, and held
   against the forward-checkpoint kernel's outputs on the same inputs.
16. The paths as their users run them, launch counters zeroed before and
   asserted exactly after: ``bw_probe.main`` for the plain stream (256 MiB
   arrays) and, at 327,680 columns, the window mixes of the port's own
   kernels (NL 15x8, forward-checkpoint 16x11, TL 16x19, streamed TL 32x16,
   AD 27x16 reversed, each plain and compute-weighted; resident 16x8 and
   fused 16x32 plain), each of which first holds the probe's kernel against
   its plain version forward and reversed; ``encoding_study.main`` on the
   card; and the encoded and resident NL sweeps through their wrappers at
   327,680 f32 columns.
17. Timing with CUDA events at 327,680 columns f32 over distinct inputs, in
   this order: exact NL, encoded (default keep), encoded ``("pq",)``,
   encoded bfloat16, the all-f32 control, resident at the default ring, at
   128 columns x 8 levels and with every level resident, exact NL again (a
   drift control); each with its bytes, attained bandwidth, bound, registers
   and spills; one encoding's time and the plain versions once at 163,840
   columns; then the probe's 15x8 mix as the one PyTorch call that computes
   it (``torch._foreach_add`` over the 8 outputs), between two timings of the
   probe's kernel on the same arrays (``library_ms``).
18. The traced schedule against the shipped one, in one process and in
   turns traced, shipped, shipped, traced, at 327,680 f32 columns: the AD
   kernel and both TL modes rebuilt with the schedule the shipped one
   replaced (the AD bodies rendered by the emitter in the traced order, AD
   at 3 blocks per SM, TL bounded by the block size alone) against the
   shipped builds, with both builds' registers and spills; then
   ``run_tlad`` on the stream contract in six processes of their own, the
   two schedules in turns, and each side's median
   (``cloudsc2jax_torch/probes/tlad_budget.py``).

The comparisons of phases 6, 9, 12 and 15 are bound by the host, so each
runs in a process of its own (``chip_smoke.py --compare <name>``, started
after the build) beside phases 3, 4, 7 and 10 of the main process; the
timing phases start when all of them have ended, and the script stops any
that is left if it fails.  A comparison's output goes to
``build/chip_smoke/<name>.log`` and its result to ``<name>.json`` beside it.
Each comparison also times the plain versions once, not warmed up, at
163,840 f32 columns (``plain_ms``, ``plain_ncol``): a plain sweep takes
seconds of host time at any size and is no yardstick of speed.
``python3 chip_smoke.py --serial`` runs the same phases in one process, to
measure what the fan-out saves (PERF.md has both times).

Each kernel's record holds its time beside its bound: the larger of the
bytes it must move (every input read once, every output written once,
from this run's tensors) over the card's published memory rate, and its
operations (statements of its level body per level and column) over the
card's published f32 rate.  No single PyTorch call computes one of the
level-recurrent sweeps, so their ``library_ms`` is null; the probe's is
phase 17's ``torch._foreach_add``.  ``ceiling_ms``
is the time the window-matched probe of phase 16 would take for the kernel's
bytes at the kernel's own mix of reads and writes per level.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
LIBRARIES = ("cloudsc2_nl", "cloudsc2_tl", "cloudsc2_tl_din", "cloudsc2_ad",
             "cloudsc2_tl_enc", "cloudsc2_ad_enc", "cloudsc2_tlad_fused",
             "cloudsc2_nl_enc", "cloudsc2_nl_res", "bw_probe")
CSRC = ROOT / "cloudsc2jax_torch" / "csrc"

# NVIDIA H100 SXM data sheet: device memory rate and f32 rate outside the
# tensor cores; the bounds below are stated against these
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# operations of the hand-written NL level body per level and column: ~292
# flops and ~10 transcendentals (the count the reference's cost estimate of
# the same body uses, cloudsc2jax/pallas/tlad_kernel.py:704-707)
NL_OPS_PER_LEVEL_COLUMN = 302

TOLERANCE = {"float32": 5e-6, "float64": 1e-12}
# The encoded NL kernel against its plain version.  Its outputs equal the
# exact kernel's on the decoded inputs bit for bit, so nothing of this is the
# encoded build's (its register cap, its spills); the decoded trajectories
# are worse conditioned than the exact one (an int16 pqs no longer is SATUR of
# the decoded pt): the worst case, tenl_t at 100 columns with pqs streamed,
# reads 4.712e-6 with and without FMA contraction while f32 rounding alone
# moves the plain version 5.0e-6 from its f64 self there
# (cloudsc2jax_torch/probes/nl_enc_fmad.py, NVIDIA H100; PERF.md)
ENC_NL_TOLERANCE = 2e-5
TLAD_TOLERANCE = {"tl": {"float32": 1e-5, "float64": 1e-11},
                  "ad": {"float32": 1e-4, "float64": 1e-11}}
TIMING_NCOL = 327_680
MAIN_PATH_RUNS = (
    ["nl", "1", "163840", "128", "--dtype", "f32", "--threshold", "10000",
     "--kernels"],
    ["nl", "1", "16384", "128", "--dtype", "f64", "--kernels"],
)
# the NL truth path through the CLI, against the same golden file
TRUTH_RUNS = (["nl", "1", "16384", "128", "--dtype", "f64"],)
# the JAX package's f32 TL parity (cloudsc2jax/cli.py:288), which the TL
# kernel built without FMA contraction holds (PERF.md)
NOFMA_TL_PARITY_TOL = 1e-6
# (ncol, dtype, ldrain1d) of the sweeps on the CLI's main paths, for the
# kernel-against-plain comparisons of the NL, TL+AD and standalone phases
COMPARE_SHAPES = [(163840, "float32", False), (16384, "float64", False)]
# (ncol, dtype, ldrain1d) of the small comparisons of the TL and AD phases:
# one block and a ragged grid, both dtypes, both evaporation settings
SMALL_CASES = [(ncol, name, ldrain1d)
               for ncol in (100, 5000)
               for name in ("float32", "float64")
               for ldrain1d in (False, True)]
TLAD_RUNS = (
    ["tlad", "1", "163840", "128", "--dtype", "f32"],
    ["tlad", "1", "16384", "128", "--dtype", "f64"],
)
TEST_RUNS = (
    ["tl", "1", "16384", "128", "--dtype", "f64", "--kernels"],
    ["ad", "1", "16384", "128", "--dtype", "f64", "--kernels"],
)
VERDICT_NCOL = 163_840
AB_CONFIGS = ["two", "noprim", "fused", "enc", "encnp", "two"]
# (ncol, dtype) of the harness's shape in the comparisons of phase 12
AB_SHAPES = ((163840, "float32"), (16384, "float64"))
# the window mixes of phase 16: label, reads, writes, reversed, and the
# tanh,flops per element of the compute-weighted run (None: plain only), as
# the JAX tool calibrates them for the NL, TL and AD bodies
PROBE_MIXES = (
    ("nl", 15, 8, False, (10, 292)),
    ("fwd", 16, 11, False, (10, 292)),
    ("tl", 16, 19, False, (20, 584)),
    ("din", 32, 16, False, (20, 584)),
    ("ad", 27, 16, True, (30, 876)),
    ("res", 16, 8, False, None),
    ("fused", 16, 32, False, None),
)
# the mix each kernel is judged against
KERNEL_MIX = {
    "cloudsc2_nl": "nl", "cloudsc2_nl_enc": "nl", "bw_probe": "nl",
    "cloudsc2_nl_res": "res", "cloudsc2_fwd_ckpt": "fwd", "cloudsc2_tl": "tl",
    "cloudsc2_tl_enc": "tl", "cloudsc2_tl_din": "din", "cloudsc2_ad": "ad",
    "cloudsc2_ad_enc": "ad", "cloudsc2_tlad_fused": "fused",
}
# (fuse_satur, keep_f32 label, payload) of the encoded NL comparisons past
# the first case, which runs every combination
ENC_SUBSET = ((True, "default", "int16"), (False, "pq", "int16"),
              (True, "all", "int16"), (False, "none", "int16"),
              (True, "pq", "bfloat16"), (False, "default", "bfloat16"))
ENC_KEEPS = ("default", "pq", "all", "none")
ENC_L1_BUDGET = 5e-4  # tests/test_pallas.py:150-154, int16 payloads
# dynamic shared memory a block may opt into on an H100 (227 KB)
RESIDENT_LIMIT_BYTES = 232_448
# columns at which phase 17 times the new kernels' plain versions
PLAIN_NCOL = 163_840


def _nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _max_rel_err(got, ref):
    """Worst field of max |got - ref| / max |ref|, and the worst absolute
    difference."""
    rel = absolute = 0.0
    for a, b in zip(got, ref):
        d = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-30)
        rel = max(rel, d / scale)
        absolute = max(absolute, d)
    return rel, absolute


def _nbytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (nested tuples; None skipped)."""
    total = 0
    for t in trees:
        if t is None:
            continue
        if hasattr(t, "numel"):
            total += t.numel() * t.element_size()
        else:
            total += _nbytes(*t)
    return total


def _level_statements(kind: str, evap: bool, lregcl: bool) -> int:
    """Statements of one generated level body, from the header's own count."""
    import re

    text = (CSRC / f"cloudsc2_{kind}_level.cuh").read_text()
    flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
    m = re.search(rf"lregcl: {flags} \((\d+) statements", text)
    if m is None:
        raise AssertionError(f"no statement count for Level<{flags}> in {kind}")
    return int(m.group(1))


def _bound(nbytes: int, ops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its f32 rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops, "library_ms": None}


def _time_ms(fn, args_list, calls: int) -> float:
    """Mean device time per call over ``calls`` calls cycling through
    ``args_list``, after one warm call per argument set."""
    import torch

    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def _time_once_ms(fn, *args) -> float:
    """Device time of one call, not warmed up: for the plain versions, whose
    sweeps take seconds of host time and are no yardstick of speed."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _timed(fn, *args):
    """``fn(*args)`` and its device time in ms, not warmed up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    value = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return value, start.elapsed_time(stop)


def _lap(phases: str, since: float) -> float:
    now = time.perf_counter()
    print(f"phases {phases}: {now - since:.1f} s")
    return now


def _check(what: str, got, ref, tol: float, worst: dict, name: str) -> None:
    import torch

    rel, absolute = _max_rel_err(got, ref)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    print(f"    {what}: max rel err {rel:.3e} (tol {tol:g}), max abs err "
          f"{absolute:.3e}, finite={finite}")
    if not finite or not rel <= tol:
        raise AssertionError(f"{what} disagrees with the plain version")
    worst[name] = max(worst.get(name, 0.0), rel)
    worst["abs"] = max(worst.get("abs", 0.0), absolute)


def compare_tlad(state, params):
    """Phase 6: the TL and AD kernels against their plain versions on the
    card.  Returns the worst errors and the plain versions' times."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_reference,
    )

    plain_ms = {}
    # -- 6. TL and AD kernels against their plain versions on the card
    worst = {"tl": {}, "ad": {}}
    tl0, ad0 = cloudsc2_tl.launches, cloudsc2_ad.launches
    cases = SMALL_CASES + COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        print(f"[6] ncol={ncol} {name} ldrain1d={ldrain1d}:")
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        kw = dict(dscale=DSCALE, ldrain1d=ldrain1d)
        out, dout, ckpts = cloudsc2_tl(inputs, params, **kw)
        none, dout_n, ckpts_n = cloudsc2_tl(inputs, params, write_primal=False, **kw)
        (r_out, r_dout, r_ckpts), t_tl = _timed(
            lambda: cloudsc2_tl_reference(inputs, params, **kw))
        adj = cloudsc2_ad(inputs, r_dout, r_ckpts, params, ldrain1d=ldrain1d)
        r_adj, t_ad = _timed(lambda: cloudsc2_ad_reference(
            inputs, r_dout, r_ckpts, params, ldrain1d=ldrain1d))
        if (ncol, name) == (PLAIN_NCOL, "float32"):
            plain_ms.update(tl=t_tl, ad=t_ad)
        if none is not None:
            raise AssertionError("write_primal=False returned primal streams")
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        w_tl, w_ad = worst["tl"], worst["ad"]
        _check("TL primal", out, r_out, tol_tl, w_tl, name)
        _check("TL tangents", dout, r_dout, tol_tl, w_tl, name)
        _check("TL checkpoints", ckpts, r_ckpts, tol_tl, w_tl, name)
        _check("TL tangents, no primal", dout_n, r_dout, tol_tl, w_tl, name)
        _check("TL checkpoints, no primal", ckpts_n, r_ckpts, tol_tl, w_tl, name)
        _check("AD adjoints", adj, r_adj, tol_ad, w_ad, name)
        if ncol == 100 and name == "float32" and not ldrain1d:
            # how far f32 rounding alone moves the adjoints: the kernel and
            # the plain version, both f32, against the plain version in f64
            i64 = state.device_kernel_inputs(ncol, dtype=torch.float64,
                                             device="cuda", pqs=True)
            _, d64, c64 = cloudsc2_tl_reference(i64, params, **kw)
            a64 = cloudsc2_ad_reference(i64, d64, c64, params)
            for label, got in (("kernel f32", adj), ("plain f32", r_adj)):
                rel = {n: (g.double() - b).abs().max().item()
                       / max(b.abs().max().item(), 1e-300)
                       for n, g, b in zip(adj._fields, got, a64)}
                print(f"    AD {label} vs plain f64: max rel err "
                      f"{max(rel.values()):.3e} (plu {rel['plu']:.3e})")
    if (cloudsc2_tl.launches - tl0, cloudsc2_ad.launches - ad0) != \
            (2 * len(cases), len(cases)):
        raise AssertionError("the comparison did not launch the kernels")

    return {"worst": worst, "plain_ms": plain_ms}


def cli_tlad():
    """Phase 7: the TL+AD main path through the CLI entry point.  Returns
    the launches it made of the two kernels."""
    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    # -- 7. TL+AD main path through the CLI entry point
    cloudsc2_tl.launches = cloudsc2_ad.launches = 0
    for argv in TLAD_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[7] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"TL+AD main path failed its check: {argv}")
    launches = {"tl": cloudsc2_tl.launches, "ad": cloudsc2_ad.launches}
    print(f"[7] kernel launches on the TL+AD main path: {launches}")
    if min(launches.values()) < len(TLAD_RUNS):
        raise AssertionError("the TL+AD main path did not run through both kernels")

    return launches


def time_tlad(state, params, compared, launches):
    """Phase 8: timing at the headline size, f32, distinct inputs per call.
    Returns the two kernels' JSON records."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        launch_cloudsc2_ad,
        launch_cloudsc2_tl,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    # -- 8. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    tls = [launch_cloudsc2_tl(i, p, params, dscale=DSCALE)
           for i, p in zip(sets, pres)]
    ms = {
        "tl": _time_ms(lambda i, p: launch_cloudsc2_tl(i, p, params, dscale=DSCALE),
                       list(zip(sets, pres)), 20),
        "tl_noprim": _time_ms(
            lambda i, p: launch_cloudsc2_tl(i, p, params, dscale=DSCALE,
                                            write_primal=False),
            list(zip(sets, pres)), 20),
        "ad": _time_ms(lambda i, p, t: launch_cloudsc2_ad(i, p, t[1], t[2], params),
                       list(zip(sets, pres, tls)), 20),
        "run_tlad": _time_ms(lambda i: run_tlad(i, params), [(s,) for s in sets], 10),
    }
    plain["unit"] = plain["tl"] + plain["ad"]
    nlev = base.pt.shape[0]
    nbytes = {"tl": ((16 * nlev + 1) + 19 * nlev) * ncol * 4,
              "tl_noprim": ((16 * nlev + 1) + 11 * nlev) * ncol * 4,
              "ad": ((27 * nlev + 1) + (16 * nlev + 1)) * ncol * 4}
    for label, t in ms.items():
        line = f"[8] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in nbytes:
            line += (f", {nbytes[label] / 1e9:.4f} GB, "
                     f"{nbytes[label] / (t * 1e-3) / 1e9:.1f} GB/s")
        print(line + f" at {ncol} columns f32")
    for label, t in plain.items():
        print(f"[8] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 6")
    print(f"[8] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    cells = nlev * ncol
    bounds = {"tl": _bound(_nbytes(sets[0], pres[0], tls[0]),
                           _level_statements("tl", False, True) * cells),
              "ad": _bound(_nbytes(sets[0], pres[0], tls[0][1], tls[0][2])
                           + _nbytes(sets[0]),
                           _level_statements("ad", False, True) * cells)}

    def record(kind, replaces):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": f"cloudsc2_{kind}",
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/cloudsc2_{kind}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "max_rel_err_f64": w["float64"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": nbytes[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
        }

    tl_rec = record("tl", "cloudsc2jax/pallas/tlad_kernel.py:170")
    tl_rec.update(ms_noprim=ms["tl_noprim"], run_tlad_ms=ms["run_tlad"],
                  plain_unit_ms=plain["unit"])
    return [tl_rec, record("ad", "cloudsc2jax/pallas/tlad_kernel.py:454")]


def compare_variants(state, params):
    """Phase 9: the checkpointing forward kernel, the streamed-increment TL
    kernel and the AD kernel's second instantiation against their plain
    versions on the card.  Returns the worst errors and the plain versions'
    times."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_fwd_ckpt,
        cloudsc2_fwd_ckpt_reference,
    )
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_din,
        cloudsc2_tl_reference,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    def increments(inputs, gen):
        """Seeded increments of 0.5-1.5% of each input, not a multiple of it."""
        return Cloudsc2Inputs(*(
            DSCALE * x * (0.5 + torch.rand(x.shape, generator=gen,
                                           device=x.device, dtype=x.dtype))
            for x in inputs))

    plain_ms = {}
    # -- 9. the new kernels against their plain versions on the card
    worst = {"fwd": {}, "din": {}, "ad": {}}
    counters = (cloudsc2_fwd_ckpt, cloudsc2_tl_din, cloudsc2_tl, cloudsc2_ad)
    before = [f.launches for f in counters]
    expected = [0, 0, 0, 0]
    cases = SMALL_CASES + COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        small = ncol <= 5000
        # f64 only: there the comparison stays at rounding level, while in
        # f32 the distance between a kernel and its plain version grows with
        # the conditioning of the perturbed trajectory (PERF.md section 6)
        perturbed = ncol == 5000 and name == "float64"
        print(f"[9] ncol={ncol} {name} ldrain1d={ldrain1d} "
              f"pqs {'perturbed' if perturbed else 'SATUR'}:")
        gen = torch.Generator(device="cuda").manual_seed(ncol)
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        if perturbed:
            inputs = inputs._replace(pqs=inputs.pqs * (0.99 + 0.02 * torch.rand(
                inputs.pqs.shape, generator=gen, device="cuda",
                dtype=inputs.pqs.dtype)))
        d_inputs = increments(inputs, gen)
        tol_nl = TOLERANCE[name]
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        out, ckpts = cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)
        (r_out, r_ckpts), t_fwd = _timed(lambda: cloudsc2_fwd_ckpt_reference(
            inputs, params, ldrain1d=ldrain1d))
        expected[0] += 1
        _check("forward outputs", out, r_out, tol_nl, worst["fwd"], name)
        _check("forward checkpoints", ckpts, r_ckpts, tol_nl, worst["fwd"], name)
        # the TL kernel reads the same pqs: its checkpoints and primal
        # streams are the forward kernel's, up to the two bodies' rounding
        t_out, _, t_ckpts = cloudsc2_tl(inputs, params, dscale=DSCALE,
                                        ldrain1d=ldrain1d)
        expected[2] += 1
        _check("forward vs TL kernel", (*out, *ckpts), (*t_out, *t_ckpts),
               tol_nl if name == "float64" else tol_tl, {}, name)
        for lregcl in ((False, True) if small else (False,)):
            kw = dict(lregcl=lregcl, ldrain1d=ldrain1d)
            p_out, p_dout = cloudsc2_tl_din(inputs, d_inputs, params, **kw)
            (rp_out, rp_dout, _), t_din = _timed(lambda: cloudsc2_tl_reference(
                inputs, params, d_inputs=d_inputs, **kw))
            if (ncol, name) == (PLAIN_NCOL, "float32"):
                plain_ms.update(fwd=t_fwd, din=t_din)
            expected[1] += 1
            what = f"streamed TL lregcl={lregcl}"
            _check(f"{what} primal", p_out, rp_out, tol_tl, worst["din"], name)
            _check(f"{what} tangents", p_dout, rp_dout, tol_tl, worst["din"], name)
        if small:
            # the AD kernel's new instantiation: lregcl off, seeds as given
            adj = cloudsc2_ad(inputs, rp_dout, r_ckpts, params, lregcl=False,
                              ldrain1d=ldrain1d, fold_seeds=False)
            r_adj = cloudsc2_ad_reference(inputs, rp_dout, r_ckpts, params,
                                          lregcl=False, ldrain1d=ldrain1d,
                                          fold_seeds=False)
            expected[3] += 1
            _check("AD lregcl=False, unfolded seeds", adj, r_adj, tol_ad,
                   worst["ad"], name)
        torch.cuda.synchronize()
    if [f.launches - b for f, b in zip(counters, before)] != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs, d_inputs, out, ckpts, r_out, r_ckpts, t_out, t_ckpts
    del p_out, p_dout, rp_out, rp_dout

    return {"worst": worst, "plain_ms": plain_ms}


def cli_variants(state, params):
    """Phase 10: the standalone TL and AD paths through the CLI entry point
    and ``measure_f32_verdicts``.  Returns the kernels' launches, the
    verdicts and the f32 TL's distances to the f64 truth path."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_fwd_ckpt
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl_din
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.tlad import cloudsc2_tl as truth_tl

    # -- 10. the standalone TL and AD paths through the CLI entry point
    path = {"fwd": cloudsc2_fwd_ckpt, "din": cloudsc2_tl_din, "ad": cloudsc2_ad}
    for f in path.values():
        f.launches = 0
    for argv in TEST_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[10] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"standalone path failed its checks: {argv}")
    std = state.device_inputs(VERDICT_NCOL, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    verdicts = cli.measure_f32_verdicts(state, std, lregcl=True)
    print(f"[10] measure_f32_verdicts at {VERDICT_NCOL} f32 columns "
          f"({time.perf_counter() - t0:.1f} s): {verdicts}")
    if not (verdicts["finite"]
            and verdicts["tl_parity_rel_err"] < verdicts["tl_parity_tol"]
            and verdicts["ad_identity_rel_err"] < verdicts["ad_identity_tol"]):
        raise AssertionError("the f32 verdicts through the kernels failed")
    launches = {k: f.launches for k, f in path.items()}
    print(f"[10] kernel launches on the standalone TL and AD paths: {launches}")
    if min(launches.values()) < len(TEST_RUNS) + 1:
        raise AssertionError("the standalone paths did not run through "
                             "every kernel")
    # where the f32 parity's budget goes: the TL kernel and the truth path,
    # both f32, each against the truth path in f64 (exact TL, lregcl off)
    ncol = 16384
    i64 = state.device_inputs(ncol, dtype=torch.float64, device="cuda")
    i32 = Cloudsc2Inputs(*(x.float() for x in i64))
    _, d64 = truth_tl(i64, Cloudsc2Inputs(*(DSCALE * x for x in i64)), params)
    _, dk32, _ = run_tlad(i32, params, lregcl=False, backend="kernels")
    _, dt32 = truth_tl(i32, Cloudsc2Inputs(*(DSCALE * x for x in i32)), params)
    dist = {}
    for label, got, ref in (("kernel f32 vs truth f64", dk32, d64),
                            ("truth f32 vs truth f64", dt32, d64),
                            ("kernel f32 vs truth f32", dk32, dt32)):
        dist[label] = max(
            ((g.double() - r.double()).abs().max()
             / r.double().abs().max().clamp_min(1e-300)).item()
            for g, r in zip(got, ref))
        print(f"[10] TL tangents at {ncol} columns, {label}: max rel err "
              f"{dist[label]:.3e}")
    # the reference's 1e-6 TL parity, held by the TL kernel built without
    # FMA contraction (its own library beside the shipped one)
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_kernel_tl

    nofma = {}
    d32 = Cloudsc2Inputs(*(DSCALE * x for x in i32))
    with build.variant("cloudsc2_tl_din", flags=("-fmad=false",)):
        for lregcl in (False, True):
            _, dk = cloudsc2_kernel_tl(i32, d32, params, lregcl=lregcl)
            nofma[f"lregcl={lregcl}"] = cli.tl_parity(i32, dk, params, lregcl=lregcl)
            print(f"[10] TL parity at {ncol} f32 columns, -fmad=false, "
                  f"lregcl={lregcl}: {nofma[f'lregcl={lregcl}']:.3e} "
                  f"(tol {NOFMA_TL_PARITY_TOL:g})")
    if not max(nofma.values()) < NOFMA_TL_PARITY_TOL:
        raise AssertionError("the TL kernel without FMA contraction misses "
                             "the reference's TL parity")
    del i64, i32, d64, dk32, dt32, std, d32

    return {"launches": launches, "verdicts": verdicts, "dist": dist,
            "tl_parity_nofma": nofma}


def time_variants(state, params, compared, ran, ad_record):
    """Phase 11: timing at the headline size, f32, distinct inputs per call.
    Returns the forward and the streamed-TL kernels' JSON records and adds
    the standalone paths' launches to the AD kernel's record."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        kernel_prelude,
        launch_cloudsc2_fwd_ckpt,
    )
    from cloudsc2jax_torch.kernels.tlad_kernel import launch_cloudsc2_tl_din
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    launches, verdicts, dist = ran["launches"], ran["verdicts"], ran["dist"]
    # -- 11. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    dsets = [Cloudsc2Inputs(*(DSCALE * x for x in s)) for s in sets]
    views = [Cloudsc2Inputs(*(x.T for x in s)) for s in sets]
    ms = {
        "fwd": _time_ms(lambda i, p: launch_cloudsc2_fwd_ckpt(i, p, params),
                        list(zip(sets, pres)), 20),
        "din": _time_ms(lambda i, d, p: launch_cloudsc2_tl_din(i, d, p, params),
                        list(zip(sets, dsets, pres)), 20),
        "run_tlad_kernels_views": _time_ms(
            lambda i: run_tlad(i, params, backend="kernels"),
            [(v,) for v in views], 10),
    }
    fwd0 = launch_cloudsc2_fwd_ckpt(sets[0], pres[0], params)
    din0 = launch_cloudsc2_tl_din(sets[0], dsets[0], pres[0], params)
    nlev = base.pt.shape[0]
    bounds = {
        "fwd": _bound(_nbytes(sets[0], pres[0], fwd0),
                      NL_OPS_PER_LEVEL_COLUMN * nlev * ncol),
        "din": _bound(_nbytes(sets[0], pres[0], dsets[0], din0),
                      _level_statements("tl", False, False) * nlev * ncol),
    }
    del dsets, views, fwd0, din0
    contiguous = [Cloudsc2Inputs(*(x.T.contiguous() for x in s)) for s in sets[:2]]
    ms["run_tlad_kernels"] = _time_ms(
        lambda i: run_tlad(i, params, backend="kernels"),
        [(c,) for c in contiguous], 6)
    for label, t in ms.items():
        line = f"[11] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in bounds:
            b = bounds[label]
            line += (f", {b['bytes'] / 1e9:.4f} GB, "
                     f"{b['bytes'] / (t * 1e-3) / 1e9:.1f} GB/s, bound "
                     f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
        print(line + f" at {ncol} columns f32")
    for label, t in plain.items():
        print(f"[11] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 9")
    print(f"[11] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    ad_record["launches_standalone_paths"] = launches["ad"]
    ad_record["max_rel_err_f32_lregcl_off"] = worst["ad"]["float32"]
    ad_record["max_rel_err_f64_lregcl_off"] = worst["ad"]["float64"]

    def record(kind, name, source, replaces, **extra):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "max_rel_err_f64": w["float64"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": bounds[kind]["bytes"] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    return [
        record("fwd", "cloudsc2_fwd_ckpt", "cloudsc2jax_torch/csrc/cloudsc2_nl.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:405"),
        record("din", "cloudsc2_tl_din", "cloudsc2jax_torch/csrc/cloudsc2_tl_din.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:170",
               run_tlad_kernels_ms=ms["run_tlad_kernels"],
               run_tlad_kernels_views_ms=ms["run_tlad_kernels_views"],
               tl_parity_rel_err=verdicts["tl_parity_rel_err"],
               tl_parity_rel_err_nofma=ran["tl_parity_nofma"],
               ad_identity_rel_err=verdicts["ad_identity_rel_err"],
               tl_f32_vs_f64=dist),
    ]


def compare_experiments(state, params):
    """Phase 12: the encoded TL and AD kernels and the fused TL+AD kernel
    against their plain versions on the card.  Returns the worst errors and
    the plain versions' times."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex

    plain_ms = {}
    # -- 12. the three kernels against their plain versions on the card
    worst = {"tl_enc": {}, "ad_enc": {}, "fused": {}}
    counters = (ex.cloudsc2_tl_encoded, ex.cloudsc2_ad_encoded,
                ex.cloudsc2_tlad_fused)
    before = [f.launches for f in counters]
    expected = [0, 0, 0]
    cases = [(100, "float32", False), (100, "float32", True),
             (5000, "float32", False), (5001, "float32", True),
             (100, "float64", True), (5001, "float64", False)]
    cases += [(ncol, name, False) for ncol, name in AB_SHAPES]
    for ncol, name, ldrain1d in cases:
        print(f"[12] ncol={ncol} {name} ldrain1d={ldrain1d}:")
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        n_terms = inputs.pt.numel()
        id_tol = (1e-10 if name == "float64" else
                  cli.scaled_identity_tol(cli.PALLAS_AD_IDENTITY_TOL, n_terms))
        kw = dict(ldrain1d=ldrain1d)
        out, dout, adj = ex.cloudsc2_tlad_fused(inputs, params, **kw)
        (r_out, r_dout, r_adj), t_fused = _timed(
            lambda: ex.cloudsc2_tlad_fused_reference(inputs, params, **kw))
        u_out, u_dout, u_adj = run_tlad(inputs, params, **kw)
        expected[2] += 1
        w = worst["fused"]
        _check("fused primal", out, r_out, tol_tl, w, name)
        _check("fused tangents", dout, r_dout, tol_tl, w, name)
        _check("fused adjoints", adj, r_adj, tol_ad, w, name)
        # the same two loops in one kernel: the two-kernel unit's results,
        # bit for bit where nvcc contracts both builds alike (it does with
        # ldrain1d off), else up to FMA contraction
        _check("fused vs two-kernel TL", (*out, *dout), (*u_out, *u_dout),
               tol_tl, {}, name)
        _check("fused vs two-kernel AD", adj, u_adj, tol_ad, {}, name)
        rel, finite = cli.adjoint_identity(inputs, dout, adj, params, DSCALE)
        print(f"    fused adjoint identity rel err {rel:.3e} (tol {id_tol:g})")
        if not (finite and rel < id_tol):
            raise AssertionError("the fused unit fails the adjoint identity")
        w["identity_" + name] = max(w.get("identity_" + name, 0.0), rel)
        del out, dout, adj, r_out, r_dout, r_adj, u_out, u_dout, u_adj
        if name != "float32":
            continue
        enc = ex.encode_blocked_inputs(inputs, params, fuse_satur=False)
        out, dout, ckpts = ex.cloudsc2_tl_encoded(enc, params, dscale=DSCALE, **kw)
        none, dout_n, ckpts_n = ex.cloudsc2_tl_encoded(
            enc, params, dscale=DSCALE, write_primal=False, **kw)
        (r_out, r_dout, r_ckpts), t_tl = _timed(
            lambda: ex.cloudsc2_tl_encoded_reference(enc, params, dscale=DSCALE,
                                                     **kw))
        adj = ex.cloudsc2_ad_encoded(enc, r_dout, r_ckpts, params, **kw)
        r_adj, t_ad = _timed(lambda: ex.cloudsc2_ad_encoded_reference(
            enc, r_dout, r_ckpts, params, **kw))
        if ncol == PLAIN_NCOL:
            plain_ms.update(fused=t_fused, tl_enc=t_tl, ad_enc=t_ad)
        expected[0] += 2
        expected[1] += 1
        if none is not None:
            raise AssertionError("write_primal=False returned primal streams")
        w = worst["tl_enc"]
        _check("encoded TL primal", out, r_out, tol_tl, w, name)
        _check("encoded TL tangents", dout, r_dout, tol_tl, w, name)
        _check("encoded TL checkpoints", ckpts, r_ckpts, tol_tl, w, name)
        _check("encoded TL tangents, no primal", dout_n, r_dout, tol_tl, w, name)
        _check("encoded TL checkpoints, no primal", ckpts_n, r_ckpts, tol_tl, w, name)
        _check("encoded AD adjoints", adj, r_adj, tol_ad, worst["ad_enc"], name)
        # the pair as the harness chains it: the AD kernel on the TL kernel's
        # own tangents and checkpoints, dx = DSCALE x the decoded inputs
        pair = ex.cloudsc2_ad_encoded(enc, dout, ckpts, params, **kw)
        expected[1] += 1
        rel, finite = cli.adjoint_identity(ex.decode_inputs(enc), dout, pair,
                                           params, DSCALE)
        print(f"    encoded pair adjoint identity rel err {rel:.3e} (tol {id_tol:g})")
        if not (finite and rel < id_tol):
            raise AssertionError("the encoded pair fails the adjoint identity")
        worst["ad_enc"]["identity"] = max(worst["ad_enc"].get("identity", 0.0), rel)
        torch.cuda.synchronize()
        del enc, out, dout, ckpts, dout_n, ckpts_n, r_out, r_dout, r_ckpts
        del adj, r_adj, pair
    if [f.launches - b for f, b in zip(counters, before)] != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs

    return {"worst": worst, "plain_ms": plain_ms}


def cli_experiments():
    """Phase 13: the ``kernel_ab`` harness as its users run it.  Returns the
    launches it made of the five kernels and its summary."""
    import os

    from cloudsc2jax_torch import kernel_ab
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    # -- 13. the harness as its users run it
    path = {"tl": cloudsc2_tl, "ad": cloudsc2_ad, "tl_enc": ex.cloudsc2_tl_encoded,
            "ad_enc": ex.cloudsc2_ad_encoded, "fused": ex.cloudsc2_tlad_fused}
    os.environ["CLOUDSC2_AB_NGPTOT"] = str(TIMING_NCOL)
    for f in path.values():
        f.launches = 0
    t0 = time.perf_counter()
    summary = kernel_ab.main(AB_CONFIGS)
    launches = {k: f.launches for k, f in path.items()}
    print(f"[13] kernel_ab {' '.join(AB_CONFIGS)} ({time.perf_counter() - t0:.1f} s); "
          f"kernel launches: {launches}")
    # per config a warm-up over the first (up to 4) variants, then the reps
    per_config = min(4, summary["reps"]) + summary["reps"]
    runs = {"tl": ("two", "noprim"), "ad": ("two", "noprim"), "fused": ("fused",),
            "tl_enc": ("enc", "encnp"), "ad_enc": ("enc", "encnp")}
    expected = {k: per_config * sum(AB_CONFIGS.count(c) for c in cfgs)
                for k, cfgs in runs.items()}
    if launches != expected:
        raise AssertionError(f"the harness did not run every unit through its "
                             f"kernels: expected {expected}")
    if summary["platform"] != "gpu" or len(summary["configs"]) != len(AB_CONFIGS):
        raise AssertionError(f"the harness's summary is incomplete: {summary}")
    return {"launches": launches, "summary": summary}


def time_experiments(state, params, compared, ran):
    """Phase 14: timing at the headline size, f32, distinct inputs per call.
    Returns the three kernels' JSON records."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    launches, summary = ran["launches"], ran["summary"]
    # -- 14. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    encs = [ex.encode_blocked_inputs(s, params, fuse_satur=False) for s in sets]
    tls = [ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE) for e in encs]
    ms = {
        "fused": _time_ms(lambda i, p: ex.launch_cloudsc2_tlad_fused(i, p, params),
                          list(zip(sets, pres)), 12),
        "tl_enc": _time_ms(
            lambda e: ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE),
            [(e,) for e in encs], 20),
        "tl_enc_noprim": _time_ms(
            lambda e: ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE,
                                                    write_primal=False),
            [(e,) for e in encs], 20),
        "ad_enc": _time_ms(
            lambda e, t: ex.launch_cloudsc2_ad_encoded(e, t[1], t[2], params),
            list(zip(encs, tls)), 20),
        "encode": _time_ms(
            lambda i: ex.encode_blocked_inputs(i, params, fuse_satur=False),
            [(s,) for s in sets], 3),
    }
    fused0 = ex.launch_cloudsc2_tlad_fused(sets[0], pres[0], params)
    slots = ex.fused_slots(sets[0], params)
    nlev = base.pt.shape[0]
    cells = nlev * ncol
    tl_ops = _level_statements("tl", False, True) * cells
    ad_ops = _level_statements("ad", False, True) * cells
    enc_in = _nbytes(encs[0].streams, encs[0].enc, pres[0])
    bounds = {
        "fused": _bound(_nbytes(sets[0], pres[0], fused0), tl_ops + ad_ops),
        "tl_enc": _bound(enc_in + _nbytes(tls[0]), tl_ops),
        "ad_enc": _bound(enc_in + _nbytes(tls[0][1], tls[0][2]) + _nbytes(sets[0]),
                         ad_ops),
    }
    # what each kernel moves, where that differs from its bound's bytes: the
    # fused kernel reads the 16 inputs in both phases and its 8 tangent
    # streams back; the TL without primal streams writes 8 streams fewer
    moved = {
        "fused": bounds["fused"]["bytes"] + _nbytes(sets[0], pres[0], fused0[1]),
        "tl_enc": bounds["tl_enc"]["bytes"],
        "tl_enc_noprim": bounds["tl_enc"]["bytes"] - _nbytes(tls[0][0]),
        "ad_enc": bounds["ad_enc"]["bytes"],
    }
    for label, t in ms.items():
        line = f"[14] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in moved:
            line += (f", {moved[label] / 1e9:.4f} GB moved, "
                     f"{moved[label] / (t * 1e-3) / 1e9:.1f} GB/s")
        if label in bounds:
            b = bounds[label]
            line += f", bound {b['bound_ms']:.4f} ms by {b['bound_by']}"
        print(line + f" at {ncol} columns f32")
    print(f"[14] fused kernel grid: {slots} resident threads, checkpoint scratch "
          f"{3 * nlev * slots * 4 / 1e6:.1f} MB")
    for label, t in plain.items():
        print(f"[14] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 12")
    print(f"[14] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    def record(kind, name, replaces, **extra):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": name,
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "bytes_moved": moved[kind],
            "gb_per_s": moved[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    return [
        record("fused", "cloudsc2_tlad_fused",
               "cloudsc2jax/pallas/experiments.py:286",
               max_rel_err_f64=worst["fused"]["float64"],
               identity_f32=worst["fused"]["identity_float32"],
               identity_f64=worst["fused"]["identity_float64"],
               resident_threads=slots, kernel_ab=summary),
        record("tl_enc", "cloudsc2_tl_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:170",
               ms_noprim=ms["tl_enc_noprim"], encode_ms=ms["encode"]),
        record("ad_enc", "cloudsc2_ad_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:454",
               identity_f32=worst["ad_enc"]["identity"]),
    ]


def _ptxas_of(lib: str, *marks: str) -> dict:
    """Registers and spill-store bytes of the first kernel entry of ``lib``
    whose mangled name holds every one of ``marks``."""
    from cloudsc2jax_torch.kernels import build

    for e in build.ptxas_report(lib):
        if all(m in e["entry"] for m in marks):
            return {"registers": e.get("registers"),
                    "spill_store_bytes": e.get("spill_store_bytes")}
    raise AssertionError(f"no kernel entry of {lib} matches {marks}")


def _l1_distance(got, ref) -> float:
    """Worst field of sum|got - ref| / sum|ref| (validate_mod.F90:271-284)."""
    return max(((a.double() - b.double()).abs().sum()
                / b.double().abs().sum().clamp_min(1e-30)).item()
               for a, b in zip(got, ref))


def _encode_nl(inputs, params, fuse_satur, keep, payload):
    """The encoding of ``inputs`` for one combination of phases 15 and 17."""
    import torch

    from cloudsc2jax_torch.kernels import experiments as ex

    keeps = {"default": ("pq", "plu", "paph"), "pq": ("pq",),
             "all": ex.ENCODED_STREAMS, "none": ()}
    return ex.encode_blocked_inputs(
        inputs, params, keep_f32=keeps[keep], fuse_satur=fuse_satur,
        payload_dtype=getattr(torch, payload))


def compare_nl_experiments(state, params):
    """Phase 15: the encoded and the resident NL kernels against their plain
    versions on the card.  Returns the worst errors and the plain versions'
    times."""
    import torch

    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex

    plain_ms = {}
    # -- 15. the two NL kernels against their plain versions on the card
    worst = {"enc": {}, "res": {}}
    counters = (ex.cloudsc2_nl_encoded, km.cloudsc2_nl_resident)
    before = [f.launches for f in counters]
    expected = [0, 0]
    every = [(fs, keep, payload) for fs in (True, False) for keep in ENC_KEEPS
             for payload in ("int16", "bfloat16")]
    enc_cases = [(100, False, every), (100, True, ENC_SUBSET),
                 (5000, False, ENC_SUBSET), (5001, True, ENC_SUBSET),
                 (163840, False, ENC_SUBSET)]
    for ncol, ldrain1d, combos in enc_cases:
        print(f"[15] encoded NL ncol={ncol} ldrain1d={ldrain1d}:")
        inputs = state.device_kernel_inputs(ncol, dtype=torch.float32,
                                            device="cuda", pqs=True)
        exact = {True: km.cloudsc2_nl(inputs, params, ldrain1d=ldrain1d),
                 False: km.cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)[0]}
        for fuse_satur, keep, payload in combos:
            enc = _encode_nl(inputs, params, fuse_satur, keep, payload)
            got = ex.cloudsc2_nl_encoded(enc, params, ldrain1d=ldrain1d)
            ref, t_enc = _timed(lambda: ex.cloudsc2_nl_encoded_reference(
                enc, params, ldrain1d=ldrain1d))
            if ncol == PLAIN_NCOL and (fuse_satur, keep, payload) == ENC_SUBSET[0]:
                plain_ms["enc"] = t_enc
            expected[0] += 1
            what = f"fuse_satur={fuse_satur} keep={keep} {payload}"
            _check(what, got, ref, ENC_NL_TOLERANCE, worst["enc"], "float32")
            # the same level body on the same decoded values: the exact
            # kernel's results, at most FMA contraction apart
            decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, params)
            twin = (km.launch_cloudsc2_nl(decoded, pre, params, ldrain1d=ldrain1d)
                    if fuse_satur else km.launch_cloudsc2_fwd_ckpt(
                        decoded, pre, params, ldrain1d=ldrain1d)[0])
            same = all(torch.equal(a, b) for a, b in zip(got, twin))
            print(f"      bit for bit the exact kernel's outputs on the decoded "
                  f"inputs: {same}")
            if not same:
                _check(what + " against the exact kernel on the decoded inputs",
                       got, twin, TOLERANCE["float32"], {}, "float32")
            del decoded, twin
            l1 = _l1_distance(got, exact[fuse_satur])
            print(f"      encoded against exact kernel: sum|a-b|/sum|b| {l1:.3e}")
            if keep == "all":
                # nothing is quantised: the exact kernel's results, up to the
                # FMA contraction of two builds
                _check(what + " against the exact kernel", got, exact[fuse_satur],
                       TOLERANCE["float32"], {}, "float32")
            elif payload == "int16" and not l1 < ENC_L1_BUDGET:
                raise AssertionError(f"{what}: int16 storage moved an output by "
                                     f"{l1:.3e} in L1, budget {ENC_L1_BUDGET:g}")
            key = "l1_" + payload
            if keep != "all":
                worst["enc"][key] = max(worst["enc"].get(key, 0.0), l1)
        torch.cuda.synchronize()
    res_cases = [(100, name, ld) for name in ("float32", "float64")
                 for ld in (False, True)]
    res_cases += [(5000, "float32", False), (5001, "float64", True)]
    res_cases += COMPARE_SHAPES
    for ncol, name, ldrain1d in res_cases:
        print(f"[15] resident NL ncol={ncol} {name} ldrain1d={ldrain1d}:")
        dtype = getattr(torch, name)
        inputs = state.device_kernel_inputs(ncol, dtype=dtype, device="cuda",
                                            pqs=True)
        nlev = inputs.pt.shape[0]
        ref, t_res = _timed(lambda: km.cloudsc2_nl_resident_reference(
            inputs, params, ldrain1d=ldrain1d))
        if (ncol, name) == (PLAIN_NCOL, "float32"):
            plain_ms["res"] = t_res
        fwd, _ = km.cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)
        rings = [("default ring", None, None), ("128 x 8", 128, 8), ("64 x 3", 64, 3)]
        if ncol <= 5001:
            per_col = km.resident_ring(nlev, dtype, tile=1, depth=nlev)[2]
            rings.append(("every level resident", RESIDENT_LIMIT_BYTES // per_col,
                          nlev))
        for label, tile, depth in rings:
            got = km.cloudsc2_nl_resident(inputs, params, ldrain1d=ldrain1d,
                                          tile=tile, depth=depth)
            expected[1] += 1
            ring = km.resident_ring(nlev, dtype, tile, depth)
            _check(f"{label} {ring}", got, ref, TOLERANCE[name], worst["res"], name)
            same = all(torch.equal(a, b) for a, b in zip(got, fwd))
            print(f"      bit for bit the forward-checkpoint kernel's outputs: {same}")
            if not same:
                # one level body in two kernels: at most FMA contraction apart
                _check(f"{label} against the forward-checkpoint kernel", got, fwd,
                       TOLERANCE[name], {}, name)
        torch.cuda.synchronize()
    try:
        km.cloudsc2_nl_resident(inputs, params, tile=128, depth=nlev)
    except ValueError as err:
        print(f"[15] a ring that does not fit is refused before the launch: {err}")
    else:
        raise AssertionError("a 128-column ring of every level was not refused")
    if [f.launches - b for f, b in zip(counters, before)] != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs, exact, enc, got, ref, fwd

    return {"worst": worst, "plain_ms": plain_ms}


def cli_nl_experiments(state, params):
    """Phase 16: ``bw_probe`` and ``encoding_study`` through their entry
    points and the two NL sweeps through their wrappers.  Returns the
    kernels' launches, the probe's records keyed by (mix, weighted), the
    plain stream's record and the study's i16 error."""
    import os

    import torch

    from cloudsc2jax_torch import bw_probe, encoding_study
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex

    # -- 16. the entry points and wrappers as their users run them
    path = {"probe": bw_probe.window_stream, "enc": ex.cloudsc2_nl_encoded,
            "res": km.cloudsc2_nl_resident}
    for f in path.values():
        f.launches = 0
    env = {k: os.environ.get(k) for k in os.environ if k.startswith("CLOUDSC2_BW_PROBE_")}
    for k in env:
        del os.environ[k]
    probes = {}
    t0 = time.perf_counter()
    try:
        os.environ["CLOUDSC2_BW_PROBE_MB"] = "256"
        stream = bw_probe.main([])
        os.environ["CLOUDSC2_BW_PROBE_NB"] = str(TIMING_NCOL // (64 * 128))
        runs = 0
        for mix, reads, writes, rev, weighted in PROBE_MIXES:
            for compute in ((0, 0), weighted):
                if compute is None:
                    continue
                os.environ["CLOUDSC2_BW_PROBE_WINDOWS"] = f"{reads}x{writes}"
                os.environ["CLOUDSC2_BW_PROBE_REV"] = "1" if rev else "0"
                os.environ["CLOUDSC2_BW_PROBE_COMPUTE"] = "%d,%d" % compute
                rec = bw_probe.main([])
                if (rec["platform"], rec["columns"], rec["rev"]) != (
                        "gpu", TIMING_NCOL, rev):
                    raise AssertionError(f"the probe ran another mix: {rec}")
                probes[mix, compute != (0, 0)] = rec
                runs += 1
                torch.cuda.empty_cache()
    finally:
        for k in [k for k in os.environ if k.startswith("CLOUDSC2_BW_PROBE_")]:
            del os.environ[k]
        os.environ.update({k: v for k, v in env.items() if v is not None})
    print(f"[16] bw_probe: plain stream and {runs} window runs "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    table = encoding_study.main([])
    i16 = table["encodings"]["i16"]["max_field_relerr"]
    print(f"[16] encoding_study on the card ({time.perf_counter() - t0:.1f} s): "
          f"i16 max field error {i16:.3e}")
    budget = table["budgets"]["onchip_budget_1e4_eps32"]
    if not 1e-4 < i16 < 2e-4 or any(
            table["encodings"][s]["max_field_relerr"] <= budget
            for s in ("bf16", "f16")):
        raise AssertionError(f"the encoding study left its band: {table}")
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    exact = km.cloudsc2_nl(base, params)
    fwd, _ = km.cloudsc2_fwd_ckpt(base, params)
    got = ex.cloudsc2_nl_encoded(ex.encode_blocked_inputs(base, params), params)
    l1 = _l1_distance(got, exact)
    res = km.cloudsc2_nl_resident(base, params)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in (*got, *res))
    res_rel, _ = _max_rel_err(res, fwd)
    print(f"[16] wrappers at {ncol} f32 columns: encoded against exact "
          f"sum|a-b|/sum|b| {l1:.3e}; resident against the forward-checkpoint "
          f"kernel max rel err {res_rel:.3e}; finite={finite}")
    if not (finite and l1 < ENC_L1_BUDGET and res_rel <= TOLERANCE["float32"]):
        raise AssertionError("the NL experiments' wrappers failed their checks")
    launches = {k: f.launches for k, f in path.items()}
    print(f"[16] kernel launches: {launches}")
    # per window run: the self-check forward and reversed, the warm-up, the reps
    per_run = 2 + bw_probe.WARMUP + 20
    if launches != {"probe": runs * per_run, "enc": 1, "res": 1}:
        raise AssertionError("the entry points did not run through their kernels")
    return {"launches": launches, "probes": probes, "stream": stream, "i16": i16}


def time_nl_experiments(state, params, compared, ran):
    """Phase 17: timing of the NL variants at the headline size, f32,
    distinct inputs per call, and the probe's mix as one library call.
    Returns the three kernels' JSON records."""
    import torch

    from cloudsc2jax_torch import bw_probe
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, launches = compared["worst"], ran["launches"]
    probes, stream, i16 = ran["probes"], ran["stream"], ran["i16"]
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    # -- 17. timing at the headline size, f32, distinct inputs per call
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [km.kernel_prelude(s, params) for s in sets]
    nlev = base.pt.shape[0]
    pairs = list(zip(sets, pres))
    enc_variants = {"enc": (True, "default", "int16"), "enc_pq": (True, "pq", "int16"),
                    "enc_bf16": (True, "default", "bfloat16"),
                    "enc_all_f32": (True, "all", "int16")}
    every_tile, every_depth, _ = km.resident_ring(
        nlev, torch.float32,
        tile=RESIDENT_LIMIT_BYTES // km.resident_ring(nlev, torch.float32, 1, nlev)[2],
        depth=nlev)
    res_variants = {"res": (None, None, 30), "res_128x8": (128, 8, 30),
                    "res_all": (every_tile, every_depth, 3)}
    out_bytes = 8 * _nbytes(base.pt)
    ms, moved, regs = {}, {}, {}

    def time_exact(label):
        ms[label] = _time_ms(lambda i, q: km.launch_cloudsc2_nl(i, q, params),
                             pairs, 30)
        moved[label] = _nbytes(sets[0]._replace(pqs=None), pres[0]) + out_bytes
        regs[label] = _ptxas_of("cloudsc2_nl", "cloudsc2_nl_kernelIfLb0E")

    time_exact("exact")
    for label, (fuse_satur, keep, payload) in enc_variants.items():
        encs = [_encode_nl(s, params, fuse_satur, keep, payload) for s in sets]
        ms[label] = _time_ms(lambda e: ex.launch_cloudsc2_nl_encoded(e, params),
                             [(e,) for e in encs], 30)
        moved[label] = _nbytes(encs[0].streams, encs[0].enc, pres[0]) + out_bytes
        regs[label] = _ptxas_of(
            "cloudsc2_nl_enc",
            "ILb0ELb0ELb1EE" if payload == "bfloat16" else "ILb0ELb0ELb0EE")
        del encs
    for label, (tile, depth, calls) in res_variants.items():
        ms[label] = _time_ms(
            lambda i, q: km.launch_cloudsc2_nl_resident(i, q, params, tile=tile,
                                                        depth=depth),
            pairs, calls)
        moved[label] = _nbytes(sets[0], pres[0]) + out_bytes
        regs[label] = _ptxas_of("cloudsc2_nl_res", "IfLb0E")
    time_exact("exact#2")
    ms["encode"] = _time_ms(lambda i: ex.encode_blocked_inputs(i, params),
                            [(s,) for s in sets], 3)
    cells = nlev * ncol
    for label, t in ms.items():
        line = f"[17] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in moved:
            b = _bound(moved[label], NL_OPS_PER_LEVEL_COLUMN * cells)
            line += (f", {moved[label] / 1e9:.4f} GB, "
                     f"{moved[label] / (t * 1e-3) / 1e9:.1f} GB/s, bound "
                     f"{b['bound_ms']:.4f} ms by {b['bound_by']}, "
                     f"{regs[label]['registers']} registers, "
                     f"{regs[label]['spill_store_bytes']} B spill stores")
        print(line + f" at {ncol} columns f32")
    print(f"[17] resident rings: default {km.resident_ring(nlev, torch.float32)}, "
          f"every level resident {(every_tile, every_depth)}")
    del sets, pres, pairs, base
    # the plain versions were timed in the comparison of phase 15; the probe's
    # is one elementwise pass per output
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = [torch.rand((nlev, PLAIN_NCOL), generator=gen, device="cuda")
            for _ in range(15)]
    plain = {**compared["plain_ms"], "probe": _time_once_ms(
        lambda a: bw_probe.window_stream_reference(a, 2.0, 8), arrs)}
    for label, t in plain.items():
        print(f"[17] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32")
    # One PyTorch call computes the probe's outputs when no chain is mixed in:
    # out[j] = in[(j+1) % R] + s * in[j % R] for all W outputs at once.  Timed
    # here on the probe's own arrays beside the kernel, used nowhere in the port.
    reads, writes = 15, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = [torch.rand((nlev, ncol), generator=gen, device="cuda")
            for _ in range(reads)]
    out = [torch.empty_like(arrs[0]) for _ in range(writes)]
    lhs = [arrs[(j + 1) % reads] for j in range(writes)]
    rhs = [arrs[j % reads] for j in range(writes)]
    want = bw_probe.window_stream_reference(arrs, 2.0, writes)
    for label, got in (
            ("kernel", bw_probe.launch_window_stream(arrs, 2.0, writes, out=out)),
            ("library call", torch._foreach_add(lhs, rhs, alpha=2.0))):
        if not all(torch.allclose(a, b, rtol=1e-6, atol=0.0)
                   for a, b in zip(got, want)):
            raise AssertionError(f"the probe's {label} disagrees with its plain "
                                 f"version at {reads}x{writes}")
    del want, got
    scales = [(1e-6 * (i + 1),) for i in range(20)]
    library = {
        "probe_kernel": _time_ms(
            lambda s: bw_probe.launch_window_stream(arrs, s, writes, out=out),
            scales, 20),
        "foreach_add": _time_ms(
            lambda s: torch._foreach_add(lhs, rhs, alpha=s), scales, 20),
        "probe_kernel#2": _time_ms(
            lambda s: bw_probe.launch_window_stream(arrs, s, writes, out=out),
            scales, 20),
    }
    for label, t in library.items():
        print(f"[17] {reads}x{writes} {label}: {t:.4f} ms/call, "
              f"{(reads + writes) * _nbytes(arrs[0]) / (t * 1e-3) / 1e9:.1f} GB/s "
              f"of the kernel's traffic at {ncol} columns f32")
    del arrs, out, lhs, rhs
    print(f"[17] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    def record(kind, name, replaces, **extra):
        return {
            **_bound(moved[kind], NL_OPS_PER_LEVEL_COLUMN * cells),
            "name": name,
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": worst[kind]["abs"],
            "max_rel_err_f32": worst[kind]["float32"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": moved[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **regs[kind],
            **extra,
        }

    nl_mix = probes["nl", False]
    # the probe's own operations: one multiply-add and one add per output
    probe_record = {
        **_bound(nl_mix["traffic_bytes"], 3 * 8 * cells),
        "name": "bw_probe",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/bw_probe.cu",
        "replaces": "tools/bw_probe.py:78",
        "launches": launches["probe"],
        "max_abs_err": max(r["self_check_max_abs_err"] for r in probes.values()),
        "ms": nl_mix["ms_per_call"],
        "plain_ms": plain["probe"],
        "plain_ncol": PLAIN_NCOL,
        "gb_per_s": nl_mix["attained_gbps"],
        "ncol": ncol,
        "library_ms": library["foreach_add"],
        "library_call": "torch._foreach_add(in[(j+1)%R], in[j%R], alpha=s)",
        "ms_beside_library": (library["probe_kernel"], library["probe_kernel#2"]),
        "stream_gb_per_s": stream["attained_gbps"],
        "mixes": {f"{mix}{'_weighted' if w else ''}": {
            k: r[k] for k in ("windows", "rev", "compute_per_element",
                              "traffic_bytes", "ms_per_call", "attained_gbps")}
            for (mix, w), r in probes.items()},
    }
    records = [
        record("enc", "cloudsc2_nl_enc", "cloudsc2jax/pallas/cloudsc2_kernel.py:348",
               ms_exact=ms["exact"], ms_exact_again=ms["exact#2"],
               ms_keep_pq=ms["enc_pq"], ms_bf16=ms["enc_bf16"],
               ms_all_f32=ms["enc_all_f32"], encode_ms=ms["encode"],
               l1_vs_exact_int16=worst["enc"]["l1_int16"],
               l1_vs_exact_bf16=worst["enc"]["l1_bfloat16"],
               encoding_study_i16=i16),
        record("res", "cloudsc2_nl_res", "cloudsc2jax/pallas/cloudsc2_kernel.py:424",
               max_rel_err_f64=worst["res"]["float64"],
               ring=km.resident_ring(nlev, torch.float32)[:2],
               ms_128x8=ms["res_128x8"], ms_every_level_resident=ms["res_all"],
               ring_every_level_resident=(every_tile, every_depth)),
        probe_record,
    ]
    return records


def _nl_compare_and_cli(state, params):
    """Phases 3 and 4: the NL kernel against its plain version, then the NL
    main path through the CLI.  Returns (worst absolute error, worst relative
    error by dtype, the main path's launches)."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_nl,
        cloudsc2_nl_reference,
    )

    # -- 3. kernel against the plain version on the card
    launches0 = cloudsc2_nl.launches
    worst_abs = 0.0
    worst_rel = {"float32": 0.0, "float64": 0.0}
    cases = [(ncol, name, ldrain1d)
             for ncol in (100, 5000)
             for name in ("float32", "float64")
             for ldrain1d in (False, True)]
    cases += COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda")
        got = cloudsc2_nl(inputs, params, ldrain1d=ldrain1d)
        ref = cloudsc2_nl_reference(inputs, params, ldrain1d=ldrain1d)
        torch.cuda.synchronize()
        rel, absolute = _max_rel_err(got, ref)
        tol = TOLERANCE[name]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        print(f"[3] ncol={ncol} {name} ldrain1d={ldrain1d}:"
              f" max rel err {rel:.3e} (tol {tol:g}), max abs err"
              f" {absolute:.3e}, finite={finite}")
        if not finite or not rel <= tol:
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"(ncol={ncol}, {name}, ldrain1d={ldrain1d})")
        worst_rel[name] = max(worst_rel[name], rel)
        worst_abs = max(worst_abs, absolute)
    if cloudsc2_nl.launches - launches0 != len(cases):
        raise AssertionError("the comparison did not launch the kernel")

    # -- 4. main path through the CLI entry point
    cloudsc2_nl.launches = 0
    for argv in MAIN_PATH_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[4] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"main path failed validation: {argv}")
    main_launches = cloudsc2_nl.launches
    print(f"[4] kernel launches on the main path: {main_launches}")
    if main_launches < len(MAIN_PATH_RUNS):
        raise AssertionError("the main path did not run through the kernel")
    for argv in TRUTH_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[4] cli {' '.join(argv)} (truth path): rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"the truth path failed validation: {argv}")
    return worst_abs, worst_rel, main_launches


def _tlad_budget():
    """The budget probe (cloudsc2jax_torch/probes/tlad_budget.py), which
    holds the traced schedule and the A/B's timing."""
    import importlib.util

    path = ROOT / "cloudsc2jax_torch" / "probes" / "tlad_budget.py"
    spec = importlib.util.spec_from_file_location("tlad_budget", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ab_schedules(state, tlad_budget, traced):
    """Phase 18: the traced schedule of the AD and both TL kernels against
    the shipped one, in turns, then ``run_tlad`` in processes of their own.
    Returns the probe's A/B result, keyed by ``tlad_budget.OLD`` and
    ``tlad_budget.NEW``."""
    # -- 18. the traced schedule against the shipped one
    old, new = tlad_budget.OLD, tlad_budget.NEW
    result = {"kernels": tlad_budget.ab_kernels(state, traced),
              "run_tlad": tlad_budget.ab_units(traced, ROOT)}
    for kind, r in result["kernels"].items():
        print(f"[18] {kind}: {old} {r[old]} ms, {new} {r[new]} ms; "
              f"ptxas {old} {r['ptxas'][old]['registers']} registers "
              f"{r['ptxas'][old]['spill_store_bytes']} B spill stores, {new} "
              f"{r['ptxas'][new]['registers']} registers "
              f"{r['ptxas'][new]['spill_store_bytes']} B spill stores")
    u = result["run_tlad"]
    print(f"[18] run_tlad medians over {len(u[old])} processes each: {old} "
          f"{u[old + '_median']:.4f} ms, {new} {u[new + '_median']:.4f} ms")
    print(f"[18] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return result


# The comparisons of phases 6, 9, 12 and 15 are bound by the host (a plain TL
# or AD sweep is ~140,000 small launches), so each runs in a process of its
# own beside the main process's phases 3, 4, 7 and 10; nothing is timed for
# the records until all of them have ended.
COMPARISONS = {
    "tlad": compare_tlad,
    "variants": compare_variants,
    "experiments": compare_experiments,
    "nl_experiments": compare_nl_experiments,
}
# where a comparison's process leaves its output (<name>.log) and its result
# (<name>.json): under the checkout's build directory
WORK_DIR = ROOT / "build" / "chip_smoke"


def _compare_worker(name: str) -> int:
    """One comparison, in a process of its own: prints what the phase prints
    and writes its result to ``WORK_DIR/<name>.json``."""
    from cloudsc2jax_torch.state import Cloudsc2State

    state = Cloudsc2State.load(FIXTURES / "input.npz")
    result = COMPARISONS[name](state, state.params)
    (WORK_DIR / f"{name}.json").write_text(json.dumps(result))
    return 0


def _start_comparisons() -> dict:
    """Start every comparison; returns name -> (process, its open log)."""
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in COMPARISONS:
        (WORK_DIR / f"{name}.json").unlink(missing_ok=True)
        log = open(WORK_DIR / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--compare", name],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        started[name] = (proc, log)
    return started


def _join_comparisons(started: dict) -> dict:
    """Wait for the comparisons, print their output, and return their
    results; raises if one failed."""
    results, failed = {}, []
    for name, (proc, log) in started.items():
        rc = proc.wait()
        log.close()
        print((WORK_DIR / f"{name}.log").read_text(), end="")
        result = WORK_DIR / f"{name}.json"
        if rc != 0 or not result.is_file():
            failed.append(f"{name} (exit code {rc})")
        else:
            results[name] = json.loads(result.read_text())
    if failed:
        raise AssertionError("comparison failed: " + ", ".join(failed))
    return results


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if argv[:1] == ["--compare"]:
        return _compare_worker(argv[1])
    serial = argv == ["--serial"]
    if argv and not serial:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()

    from cloudsc2jax_torch.bw_probe import probe_defines
    from cloudsc2jax_torch.drivers import run_nl
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_nl_reference,
        kernel_prelude,
        launch_cloudsc2_nl,
        unblock_outputs,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    # -- 1. card
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = _nvidia_smi("name,power.limit")
    print(f"[1] card: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} device(s))")
    print(card)

    # -- 2. build, every nvcc run together: the shipped libraries, the probe's
    # mixes, the TL kernel without FMA contraction (phase 10) and the
    # traced schedule of the TL and AD kernels (phase 18)
    # (the traced AD bodies are rendered while the others build)
    import concurrent.futures

    t0 = time.perf_counter()
    tlad_budget = _tlad_budget()
    specs = [(lib, (), ()) for lib in LIBRARIES if lib != "bw_probe"]
    for _, reads, writes, _, weighted in PROBE_MIXES:
        specs += [("bw_probe", probe_defines(reads, writes, c), ())
                  for c in ((0, 0), weighted) if c is not None]
    specs += [("cloudsc2_tl_din", (), ("-fmad=false",))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build.load_libraries, specs)
        traced = tlad_budget.traced_variants()
        render_s = time.perf_counter() - t0
        building.result()
    traced_specs = [(lib, defines, flags) for lib, (defines, flags) in traced.items()]
    build.load_libraries(traced_specs)
    specs += traced_specs
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.1f} s for {len(specs)} libraries, the traced "
          f"AD bodies rendered meanwhile in {render_s:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for lib, defines, flags in specs:
        tag = " ".join([*(d.split("_", 2)[2] for d in defines),
                        *(f for f in flags if not f.startswith("-I"))])
        for e in build.ptxas_report(lib, defines, flags):
            print(f"    ptxas {tag} "
                  f"{e['entry']}: {e.get('registers')} registers, "
                  f"{e.get('stack_bytes')} B stack, "
                  f"{e.get('spill_store_bytes')} B spill stores, "
                  f"{e.get('spill_load_bytes')} B spill loads")

    state = Cloudsc2State.load(FIXTURES / "input.npz")
    params = state.params
    t_phase = _lap("1-2", t_start)
    if serial:
        # every phase in this process, to measure what the fan-out saves
        nl_compare = _nl_compare_and_cli(state, params)
        tlad_launches = cli_tlad()
        variants_ran = cli_variants(state, params)
        t_phase = _lap("3-4, 7, 10", t_phase)
        compared = {name: fn(state, params) for name, fn in COMPARISONS.items()}
        t_phase = _lap("6, 9, 12, 15 in this process", t_phase)
    else:
        comparisons = _start_comparisons()
        try:
            nl_compare = _nl_compare_and_cli(state, params)
            tlad_launches = cli_tlad()
            variants_ran = cli_variants(state, params)
            t_phase = _lap("3-4, 7, 10 in the main process", t_phase)
            compared = _join_comparisons(comparisons)
        finally:
            for proc, log in comparisons.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        t_phase = _lap("6, 9, 12, 15 in their processes, waited for", t_phase)
    worst_abs, worst_rel, main_launches = nl_compare
    # -- 5. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda")
    sets = [base] + [Cloudsc2Inputs(*(None if x is None else x.roll(s, dims=1)
                                      for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    kernel_ms = _time_ms(
        lambda i, p: launch_cloudsc2_nl(i, p, params), list(zip(sets, pres)), 30)
    prelude_ms = _time_ms(lambda i: kernel_prelude(i, params),
                          [(s,) for s in sets], 30)
    run_nl_ms = _time_ms(lambda i: run_nl(i, params), [(s,) for s in sets], 30)
    streams = [run_nl(s, params) for s in sets]
    contract_ms = _time_ms(lambda o: unblock_outputs(o, params),
                           [(o,) for o in streams], 30)
    del streams
    views = [Cloudsc2Inputs(*(None if x is None else x.T for x in s)) for s in sets]
    run_nl_kernels_ms = _time_ms(lambda i: run_nl(i, params, backend="kernels"),
                                 [(v,) for v in views], 30)
    del views
    plain_ms = _time_once_ms(lambda i: cloudsc2_nl_reference(i, params), sets[0])
    nlev = base.pt.shape[0]
    nbytes = (15 * nlev + 1 + 8 * nlev) * ncol * 4
    for label, ms in (("kernel", kernel_ms), ("pre-kernel torch", prelude_ms),
                      ("run_nl (stream contract: pre-kernel + kernel)", run_nl_ms),
                      ("output contract (unblock_outputs, once per validation)",
                       contract_ms),
                      ("run_nl(backend='kernels') on transposed views", run_nl_kernels_ms),
                      ("plain version", plain_ms)):
        print(f"[5] {label}: {ms:.4f} ms/call, {ncol / (ms * 1e-3):.4e} cols/s"
              f" at {ncol} columns f32")
    print(f"[5] kernel bytes/call {nbytes} ({nbytes / 1e9:.4f} GB), attained "
          f"{nbytes / (kernel_ms * 1e-3) / 1e9:.1f} GB/s")
    print(f"[5] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    nl_record = {
        **_bound(_nbytes(sets[0], pres[0]) + 8 * _nbytes(base.pt),
                 NL_OPS_PER_LEVEL_COLUMN * nlev * ncol),
        "name": "cloudsc2_nl",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/cloudsc2_nl.cu",
        "replaces": "cloudsc2jax/pallas/cloudsc2_kernel.py:348",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_err_f32": worst_rel["float32"],
        "max_rel_err_f64": worst_rel["float64"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "prelude_ms": prelude_ms,
        "run_nl_ms": run_nl_ms,
        "contract_ms": contract_ms,
        "run_nl_kernels_ms": run_nl_kernels_ms,
        "ncol": ncol,
        "build_s": build_s,
    }
    del sets, pres, base
    t_phase = _lap("5", t_phase)
    tlad_records = time_tlad(state, params, compared["tlad"], tlad_launches)
    t_phase = _lap("8", t_phase)
    test_records = time_variants(state, params, compared["variants"], variants_ran,
                                 ad_record=tlad_records[1])
    t_phase = _lap("11", t_phase)
    ab_ran = cli_experiments()
    ab_records = time_experiments(state, params, compared["experiments"], ab_ran)
    tlad_records[0]["launches_kernel_ab"] = ab_ran["launches"]["tl"]
    tlad_records[1]["launches_kernel_ab"] = ab_ran["launches"]["ad"]
    t_phase = _lap("13-14", t_phase)
    nl_ran = cli_nl_experiments(state, params)
    nl_records = time_nl_experiments(state, params, compared["nl_experiments"],
                                     nl_ran)
    probes = nl_ran["probes"]
    t_phase = _lap("16-17", t_phase)
    ab = ab_schedules(state, tlad_budget, traced)
    ab_kind = {"cloudsc2_tl": "tl", "cloudsc2_ad": "ad", "cloudsc2_tl_din": "din"}
    for rec in tlad_records + test_records:
        if rec["name"] in ab_kind:
            rec["ab"] = ab["kernels"][ab_kind[rec["name"]]]
    tlad_records[0]["ab_run_tlad"] = ab["run_tlad"]
    _lap("18", t_phase)
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    records = [nl_record, *tlad_records, *test_records, *ab_records, *nl_records]
    for rec in records:
        # the window-matched probe's rate at this kernel's mix, for its bytes
        mix = KERNEL_MIX[rec["name"]]
        plain = probes[mix, False]
        rec["ceiling_mix"] = plain["windows"] + (" reversed" if plain["rev"] else "")
        rec["ceiling_ms"] = rec["bytes"] / (plain["attained_gbps"] * 1e9) * 1e3
        if (mix, True) in probes:
            rec["weighted_probe_ms"] = probes[mix, True]["ms_per_call"]
        print(f"ceiling {rec['name']}: {rec['ms']:.4f} ms against "
              f"{rec['ceiling_ms']:.4f} ms at {rec['ceiling_mix']} "
              f"({rec['ceiling_ms'] / rec['ms']:.1%}), bound "
              f"{rec['bound_ms']:.4f} ms")

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
