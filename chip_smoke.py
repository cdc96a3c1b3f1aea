#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: the
nonlinear sweep, the TL+AD work unit, the standalone TL and AD variants
(Taylor test, adjoint test, f32 verdicts through the kernels), and the
``kernel_ab`` harness over the work unit's schedules (two-kernel, fused,
int16-encoded).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Card: a CUDA device must be present; print its name and power limit.
2. Build: compile ``cloudsc2jax_torch/csrc/cloudsc2_{nl,tl,tl_din,ad,
   tl_enc,ad_enc,tlad_fused}.cu`` with nvcc from the checkout's sources, the
   seven builds started together; print the build time and ptxas' registers
   and spills per kernel entry.
3. NL kernel against its plain PyTorch version on the card, on the same
   inputs: the 100-column fixture and a ragged 5,000-column expansion,
   f32 and f64, ldrain1d off and on; then the main path's own shapes
   (163,840 columns f32 and 16,384 f64, ldrain1d off) on inputs built by
   ``Cloudsc2State.device_kernel_inputs`` as the CLI builds them; max
   |kernel - plain| over the field's max |plain| within 1e-12 (f64) and
   5e-6 (f32).
4. Main path through the CLI entry point on ``cuda``:
   ``nl 1 163840 128 --dtype f32 --threshold 10000`` and
   ``nl 1 16384 128 --dtype f64``, both validating against the golden
   file; the kernel's launch counter, zeroed just before, must show that
   both ran through the kernel.
5. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the kernel, the pre-kernel PyTorch work, the whole ``run_nl`` call and
   the plain version, with the bytes the sweep must move and the attained
   bandwidth.
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
   ``run_tlad`` call and the plain unit (one call), with each kernel's bytes
   and attained bandwidth.

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
   truth path, both f32, sit from the truth path in f64.
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

Each kernel's record holds its time beside its bound: the larger of the
bytes it must move (every input read once, every output written once,
from this run's tensors) over the card's published memory rate, and its
operations (statements of its level body per level and column) over the
card's published f32 rate.  No single PyTorch call computes one of these
level-recurrent sweeps, so ``library_ms`` is null throughout.

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
             "cloudsc2_tl_enc", "cloudsc2_ad_enc", "cloudsc2_tlad_fused")
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
TLAD_TOLERANCE = {"tl": {"float32": 1e-5, "float64": 1e-11},
                  "ad": {"float32": 1e-4, "float64": 1e-11}}
TIMING_NCOL = 327_680
MAIN_PATH_RUNS = (
    ["nl", "1", "163840", "128", "--dtype", "f32", "--threshold", "10000"],
    ["nl", "1", "16384", "128", "--dtype", "f64"],
)
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
    m = re.search(rf"lregcl: {flags} \((\d+) statements\)", text)
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


def _tlad_phases(state, params):
    """Phases 6-8: the TL and AD kernels against their plain versions, the
    TL+AD main path through the CLI, and its timing.  Returns the two
    kernels' JSON records."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_reference,
        launch_cloudsc2_ad,
        launch_cloudsc2_tl,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

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
        r_out, r_dout, r_ckpts = cloudsc2_tl_reference(inputs, params, **kw)
        adj = cloudsc2_ad(inputs, r_dout, r_ckpts, params, ldrain1d=ldrain1d)
        r_adj = cloudsc2_ad_reference(inputs, r_dout, r_ckpts, params,
                                      ldrain1d=ldrain1d)
        torch.cuda.synchronize()
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
        "plain_tl": _time_ms(lambda i: cloudsc2_tl_reference(i, params, dscale=DSCALE),
                             [(sets[0],)], 1),
        "plain_ad": _time_ms(lambda i, t: cloudsc2_ad_reference(i, t[1], t[2], params),
                             [(sets[0], tls[0])], 1),
    }
    ms["plain_unit"] = ms["plain_tl"] + ms["plain_ad"]
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
    print(f"[8] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    cells = nlev * ncol
    bounds = {"tl": _bound(_nbytes(sets[0], pres[0], tls[0]),
                           _level_statements("tl", False, True) * cells),
              "ad": _bound(_nbytes(sets[0], pres[0], tls[0][1], tls[0][2])
                           + _nbytes(sets[0]),
                           _level_statements("ad", False, True) * cells)}

    def record(kind, replaces, plain):
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
            "plain_ms": ms[plain],
            "gb_per_s": nbytes[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
        }

    tl_rec = record("tl", "cloudsc2jax/pallas/tlad_kernel.py:170", "plain_tl")
    tl_rec.update(ms_noprim=ms["tl_noprim"], run_tlad_ms=ms["run_tlad"],
                  plain_unit_ms=ms["plain_unit"])
    return [tl_rec, record("ad", "cloudsc2jax/pallas/tlad_kernel.py:454",
                           "plain_ad")]


def _test_variant_phases(state, params, ad_record):
    """Phases 9-11: the checkpointing forward kernel and the
    streamed-increment TL kernel against their plain versions, the
    standalone TL and AD paths through the CLI, and their timing.  Returns
    the two kernels' JSON records and adds this path's launches to the AD
    kernel's record."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_fwd_ckpt,
        cloudsc2_fwd_ckpt_reference,
        kernel_prelude,
        launch_cloudsc2_fwd_ckpt,
    )
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_din,
        cloudsc2_tl_reference,
        launch_cloudsc2_tl_din,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.tlad import cloudsc2_tl as truth_tl

    def increments(inputs, gen):
        """Seeded increments of 0.5-1.5% of each input, not a multiple of it."""
        return Cloudsc2Inputs(*(
            DSCALE * x * (0.5 + torch.rand(x.shape, generator=gen,
                                           device=x.device, dtype=x.dtype))
            for x in inputs))

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
        r_out, r_ckpts = cloudsc2_fwd_ckpt_reference(inputs, params,
                                                     ldrain1d=ldrain1d)
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
            rp_out, rp_dout, _ = cloudsc2_tl_reference(inputs, params,
                                                       d_inputs=d_inputs, **kw)
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
    del i64, i32, d64, dk32, dt32, std

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
        "plain_fwd": _time_ms(lambda i: cloudsc2_fwd_ckpt_reference(i, params),
                              [(sets[0],)], 1),
        "plain_din": _time_ms(
            lambda i, d: cloudsc2_tl_reference(i, params, d_inputs=d, lregcl=False),
            [(sets[0], dsets[0])], 1),
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
    print(f"[11] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    ad_record["launches_standalone_paths"] = launches["ad"]
    ad_record["max_rel_err_f32_lregcl_off"] = worst["ad"]["float32"]
    ad_record["max_rel_err_f64_lregcl_off"] = worst["ad"]["float64"]

    def record(kind, name, source, replaces, plain, **extra):
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
            "plain_ms": ms[plain],
            "gb_per_s": bounds[kind]["bytes"] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    return [
        record("fwd", "cloudsc2_fwd_ckpt", "cloudsc2jax_torch/csrc/cloudsc2_nl.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:405", "plain_fwd"),
        record("din", "cloudsc2_tl_din", "cloudsc2jax_torch/csrc/cloudsc2_tl_din.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:170", "plain_din",
               run_tlad_kernels_ms=ms["run_tlad_kernels"],
               run_tlad_kernels_views_ms=ms["run_tlad_kernels_views"],
               tl_parity_rel_err=verdicts["tl_parity_rel_err"],
               ad_identity_rel_err=verdicts["ad_identity_rel_err"],
               tl_f32_vs_f64=dist),
    ]


def _experiment_phases(state, params):
    """Phases 12-14: the encoded TL and AD kernels and the fused TL+AD
    kernel against their plain versions, the ``kernel_ab`` harness, and
    their timing.  Returns the three kernels' JSON records and the launches
    the harness made of the TL and AD kernels."""
    import os

    import torch

    from cloudsc2jax_torch import cli, kernel_ab
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

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
        r_out, r_dout, r_adj = ex.cloudsc2_tlad_fused_reference(inputs, params, **kw)
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
        r_out, r_dout, r_ckpts = ex.cloudsc2_tl_encoded_reference(
            enc, params, dscale=DSCALE, **kw)
        adj = ex.cloudsc2_ad_encoded(enc, r_dout, r_ckpts, params, **kw)
        r_adj = ex.cloudsc2_ad_encoded_reference(enc, r_dout, r_ckpts, params, **kw)
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
        "plain_fused": _time_ms(
            lambda i: ex.cloudsc2_tlad_fused_reference(i, params), [(sets[0],)], 1),
        "plain_tl_enc": _time_ms(
            lambda e: ex.cloudsc2_tl_encoded_reference(e, params, dscale=DSCALE),
            [(encs[0],)], 1),
        "plain_ad_enc": _time_ms(
            lambda e, t: ex.cloudsc2_ad_encoded_reference(e, t[1], t[2], params),
            [(encs[0], tls[0])], 1),
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
    print(f"[14] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    def record(kind, name, replaces, plain, **extra):
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
            "plain_ms": ms[plain],
            "bytes_moved": moved[kind],
            "gb_per_s": moved[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    records = [
        record("fused", "cloudsc2_tlad_fused",
               "cloudsc2jax/pallas/experiments.py:286", "plain_fused",
               max_rel_err_f64=worst["fused"]["float64"],
               identity_f32=worst["fused"]["identity_float32"],
               identity_f64=worst["fused"]["identity_float64"],
               resident_threads=slots, kernel_ab=summary),
        record("tl_enc", "cloudsc2_tl_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:170", "plain_tl_enc",
               ms_noprim=ms["tl_enc_noprim"], encode_ms=ms["encode"]),
        record("ad_enc", "cloudsc2_ad_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:454", "plain_ad_enc",
               identity_f32=worst["ad_enc"]["identity"]),
    ]
    return records, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    t_start = time.perf_counter()

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import run_nl
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_nl,
        cloudsc2_nl_reference,
        kernel_prelude,
        launch_cloudsc2_nl,
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

    # -- 2. build, the seven nvcc runs together
    t0 = time.perf_counter()
    build.load_libraries(list(LIBRARIES))
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for lib in LIBRARIES:
        for e in build.ptxas_report(lib):
            print(f"    ptxas {e['entry']}: {e.get('registers')} registers, "
                  f"{e.get('stack_bytes')} B stack, "
                  f"{e.get('spill_store_bytes')} B spill stores, "
                  f"{e.get('spill_load_bytes')} B spill loads")

    # -- 3. kernel against the plain version on the card
    state = Cloudsc2State.load(FIXTURES / "input.npz")
    params = state.params
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
    wrapper_ms = _time_ms(lambda i: cloudsc2_nl(i, params),
                          [(s,) for s in sets], 30)
    run_nl_ms = _time_ms(lambda i: run_nl(i, params), [(s,) for s in sets], 30)
    plain_ms = _time_ms(lambda i: cloudsc2_nl_reference(i, params),
                        [(s,) for s in sets[:2]], 2)
    nlev = base.pt.shape[0]
    nbytes = (15 * nlev + 1 + 8 * nlev) * ncol * 4
    for label, ms in (("kernel", kernel_ms), ("pre-kernel torch", prelude_ms),
                      ("wrapper (pre-kernel + kernel)", wrapper_ms),
                      ("run_nl (wrapper + output contract)", run_nl_ms),
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
        "ncol": ncol,
        "build_s": build_s,
    }
    del sets, pres, base
    t_phase = _lap("1-5", t_start)
    tlad_records = _tlad_phases(state, params)
    t_phase = _lap("6-8", t_phase)
    test_records = _test_variant_phases(state, params, tlad_records[1])
    t_phase = _lap("9-11", t_phase)
    ab_records, ab_launches = _experiment_phases(state, params)
    tlad_records[0]["launches_kernel_ab"] = ab_launches["tl"]
    tlad_records[1]["launches_kernel_ab"] = ab_launches["ad"]
    _lap("12-14", t_phase)
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [nl_record, *tlad_records, *test_records,
                                  *ab_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
