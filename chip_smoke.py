#!/usr/bin/env python3
"""Drive the PyTorch port's nonlinear main path once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Card: a CUDA device must be present; print its name and power limit.
2. Build: compile ``cloudsc2jax_torch/csrc/cloudsc2_nl.cu`` with nvcc from
   the checkout's sources; print the build time and ptxas' registers and
   spills per kernel entry.
3. Kernel against its plain PyTorch version on the card, on the same
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

TOLERANCE = {"float32": 5e-6, "float64": 1e-12}
TIMING_NCOL = 327_680
MAIN_PATH_RUNS = (
    ["nl", "1", "163840", "128", "--dtype", "f32", "--threshold", "10000"],
    ["nl", "1", "16384", "128", "--dtype", "f64"],
)
# (ncol, dtype, ldrain1d) of the sweep in each MAIN_PATH_RUNS entry
MAIN_PATH_SHAPES = ((163840, "float32", False), (16384, "float64", False))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

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

    # -- 2. build
    t0 = time.perf_counter()
    build.load_library("cloudsc2_nl")
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for e in build.ptxas_report("cloudsc2_nl"):
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
    cases += MAIN_PATH_SHAPES
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

    print(card)
    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
