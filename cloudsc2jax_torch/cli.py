"""Command-line entry points.

Port of :mod:`cloudsc2jax.cli` (reference
``src/cloudsc2_{nl,tl,ad}/dwarf_cloudsc.F90``)::

    python -m cloudsc2jax_torch nl <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch tl <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch ad <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch tlad <numdev> <ngptot> <nproma> [--kernels]

``numdev`` is the number of lanes of this process (the reference's OpenMP
threads): distinct cards on ``cuda``, repeated CPU lanes on ``cpu``.  A
multi-process launch exports ``CLOUDSC2_NUM_PROCESSES``,
``CLOUDSC2_PROCESS_ID`` and ``CLOUDSC2_COORDINATOR`` (``host:port`` of rank
0) to every process, as for the JAX CLI (the mpirun analogue); the
processes join a ``gloo`` group before any device work
(:func:`~cloudsc2jax_torch.dist.initialize`).  NGPTOT is rounded up to a
multiple of all lanes; each rank expands only its own columns on its lanes
(``dist.lane_slices``), runs the kernels there, and the verdicts are
reduced over the lanes and the ranks, so every rank exits with the same
code; only rank 0 prints the tables and verdicts.  ``nproma`` is the block
size of the Taylor test's statistics, of the reporting table and of the
truth path's ``tlad`` (the kernels own one column per thread).  The input is
expanded on the device.

* ``nl`` runs the NL sweep ``--repeat`` times and validates the outputs on
  the device against the golden file: the truth path
  (``run_nl(backend="truth")``, the JAX package's ``xla``), or with
  ``--kernels`` the main path, the fused SATUR+CLOUDSC2 kernel on the
  stream contract (``backend="streams"``, JAX's ``--pallas``), whose
  streams are assembled into the ``(ncol, nlev)`` contract once, after the
  timed loop, for the validation.
* ``tl`` runs the Taylor test (``drivers.taylor_test``, LREGCL off) on the
  truth path, ``torch.func.jvp`` of ``physics.cloudsc2.cloudsc2``, and
  prints the reference's report ("TEST PASSED, penalty ...").
* ``ad`` runs the adjoint symmetry test (``drivers.adjoint_test``, LREGCL
  on) on the truth path and prints "TEST OK"; ``--threshold`` is in
  working-precision epsilons (default 1e4).
* ``--kernels`` (the JAX package's ``--pallas``) on ``tl`` and ``ad`` adds
  the f32 verdict through the hand-written kernels on the standard contract
  (``run_tlad(backend="kernels")``): for ``tl`` the parity of the TL
  kernel's tangents with ``jvp`` of the truth path on the same f32 inputs,
  for ``ad`` the adjoint identity through the TL and AD kernels.  It is
  reported beside the f64 verdict, not instead of it.
* ``tlad`` runs the TL+AD work unit (``drivers.run_tlad``, LREGCL on)
  ``--repeat`` times and checks the adjoint identity <Mdx, Mdx> = <dx, M^T
  M dx> with dx = DSCALE·x: the truth path (``backend="truth"``, the JAX
  package's ``xla``, its ``vjp`` level-checkpointed) in NPROMA column blocks
  when ``nproma < ngptot``, at 1e-10 (f64) or 1e-5 (f32, scaled with the
  reduction length); or with ``--kernels`` the main path, the TL and AD
  kernels on the stream contract (``backend="streams"``, JAX's
  ``--pallas``), at 2e-6 (f32, scaled; 1e-5 for the plain versions with
  ``--device cpu``).

Timing: the lanes of a process run one timed region, so the lanes' rows
mirror lane 0's clock unless ``--per-device-timing`` re-times each lane's
share on its own device (``nl``, ``tlad``); with several processes rank 0
prints the gathered per-rank table (``timer.PerformanceTimer``).

Observability and golden files, as in the reference (dwarf_cloudsc.F90):

* ``CLOUDSC2_WRITE_REFERENCE=1`` makes an ``nl`` run write the golden file
  of its first ``klon_file`` columns into the working directory
  (:meth:`Cloudsc2State.write_reference`), after the one assembly of the
  ``(ncol, nlev)`` contract.  The file is ``reference.npz``, not the JAX
  package's ``reference.h5``: the port's fixtures are ``.npz`` and the card's
  machine has no ``h5py``; ``--reference`` reads either.
* ``EC_PMON=1`` reads an energy counter at the start and prints
  ``EC_PMON: energy=… J over …s (<counter>)`` after the table
  (:func:`timer.energy_probe`): the cards' own through NVML on a card, else
  the host's; nothing is printed where no counter can be read.
* ``--profile DIR`` runs everything after the input's expansion under
  ``torch.profiler`` (CPU activity, and CUDA activity on a card) and writes
  a Chrome trace into ``DIR``, then prints the table of the port's spans
  (:mod:`cloudsc2jax_torch.spans`, ranges ``cloudsc2.<span>`` in the
  trace): per span its calls, its self device ms a call (CUDA events on a
  card, the host's clock on the CPU), its host ms a call and its share of
  the ``run_nl``/``run_tlad`` spans' device time.  The spans: ``run_nl``,
  ``run_tlad`` (one per call and lane), ``prelude``, ``nl_sweep``,
  ``tl_sweep``, ``fwd_sweep``, ``ad_sweep``, ``levels_major``,
  ``contract``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import pathlib
import sys

_FIXTURES = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"


def _build_parser():
    p = argparse.ArgumentParser(
        prog="cloudsc2jax_torch",
        description="CLOUDSC2 NL, TL, AD and TL+AD drivers on CUDA devices "
                    "(PyTorch port)",
    )
    p.add_argument("variant", choices=["nl", "tl", "ad", "tlad"],
                   help="nl/tl/ad mirror the three reference dwarfs; tlad "
                        "runs the TL+AD production work unit")
    p.add_argument("numdev", type=int, nargs="?", default=1,
                   help="number of devices (lanes) of this process "
                        "(reference: OpenMP threads); distinct cards on cuda")
    p.add_argument("ngptot", type=int, nargs="?", default=100)
    p.add_argument("nproma", type=int, nargs="?", default=100,
                   help="block size for Taylor-test statistics / reporting")
    p.add_argument("--input", default=None,
                   help="input store (.npz or .h5; default: bundled fixture)")
    p.add_argument("--reference", default=None,
                   help="golden store for NL validation (.npz or .h5)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--dtype", choices=["f64", "f32"], default="f64",
                   help="working precision (JPRB double / -DSINGLE analogue)")
    p.add_argument("--repeat", type=int, default=1, help="benchmark repetitions")
    p.add_argument("--kernels", action="store_true",
                   help="nl, tlad: run the CUDA kernels on the stream "
                        "contract instead of the truth path; tl/ad: add the f32 "
                        "verdict through the CUDA kernels on the standard "
                        "contract (their plain versions with --device cpu)")
    p.add_argument("--levapls2", action="store_true",
                   help="switch on YOPHNC LEVAPLS2, the evaporation of falling "
                        "rain and snow (cloudsc2.F90:556-591), which the "
                        "dwarf's drivers force off (dwarf_cloudsc.F90:104-105); "
                        "the golden file was made without it")
    p.add_argument("--threshold", type=float, default=None,
                   help="tolerance in units of the working precision's "
                        "machine epsilon; defaults per variant: 10 for nl "
                        "validation (validate_mod.F90:285-289; f32 runs "
                        "validate at 1e4), 1e4 for the ad symmetry test "
                        "(cloudsc_driver_ad_mod.F90:289)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the CUDA kernels; cpu runs their plain "
                        "PyTorch versions")
    p.add_argument("--per-device-timing", action="store_true",
                   help="after the SPMD run, re-time each device's shard "
                        "share on its own device so the perf table prints "
                        "measured per-device clocks instead of lane-0 "
                        "mirrors (chip-skew diagnostic; nl/tlad; in "
                        "multi-process runs each rank measures its local "
                        "devices and the gathered table labels the rows)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the run with torch.profiler and write a "
                        "Chrome trace into DIR (the DR_HOOK/EC_PMON "
                        "observability analogue)")
    return p


# the golden file that CLOUDSC2_WRITE_REFERENCE=1 writes, in the working
# directory
WRITTEN_REFERENCE = "reference.npz"


@contextlib.contextmanager
def profiled(directory, device):
    """``torch.profiler`` around the body, its Chrome trace written to
    ``directory/cloudsc2jax_torch.<pid>.pt.trace.json``; nothing without a
    directory (``jax.profiler.trace`` at ``cloudsc2jax/cli.py:181-188``)."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from . import spans

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    spans.clear()
    with profile(activities=activities) as prof:
        yield
    trace = path / f"cloudsc2jax_torch.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(str(trace))
    print(f"profile written to {trace}", file=sys.stderr)
    print_spans(spans.summary(), sys.stderr)


def print_spans(summary: dict, file) -> None:
    """The table of :func:`spans.summary`: per span its calls, self device
    ms and host ms a call, its self time's share of the entry spans'
    (``run_nl``, ``run_tlad``) device time, and its counters (the kernel
    instance a sweep launched), ``name=value`` each."""
    from . import spans

    entries = sum(s["device_ms"] for name, s in summary.items()
                  if name in (spans.PREFIX + "run_nl", spans.PREFIX + "run_tlad"))
    print(f"{'span':>24} {'calls':>7} {'self ms/call':>13} {'host ms/call':>13}"
          f" {'% of run':>9}  counters", file=file)
    for name, s in sorted(summary.items(), key=lambda kv: -kv[1]["self_ms"]):
        share = 100.0 * s["self_ms"] / entries if entries else float("nan")
        counters = " ".join(f"{k}={v:g}" for k, v in s.get("counters", {}).items())
        print(f"{name:>24} {s['count']:>7} {s['self_ms'] / s['count']:>13.4f}"
              f" {s['host_ms'] / s['count']:>13.4f} {share:>9.2f}  {counters}".rstrip(),
              file=file)


# f32 verdict of the adjoint identity through the kernels: the JAX
# package's budget for its Pallas pair (cloudsc2jax/cli.py:289), 5-10x
# above the distribution measured there, so a broken damp site (>1e-4)
# trips it while rounding does not.
PALLAS_AD_IDENTITY_TOL = 2.0e-6

# The identity's rel err is a rounding random walk over ~ngptot*nlev-term
# dot products, so it grows ~sqrt(n_terms); the tolerance was anchored at
# 16384x137 and scales with sqrt(n/ref) past it, never tightening below
# the base (cloudsc2jax/cli.py:291-304).
IDENTITY_TOL_REF_TERMS = 16384 * 137


def scaled_identity_tol(base: float, n_terms: int) -> float:
    return base * max(1.0, math.sqrt(max(n_terms, 1) / IDENTITY_TOL_REF_TERMS))


# f32 verdict of the TL parity through the kernel: max over the 10 fields
# of max |kernel - jvp| / max |jvp|, independent of the reduction length, so
# it is not scaled.  The JAX package's value (cloudsc2jax/cli.py:288).  The
# TL kernel behind it (the standard contract's: csrc/cloudsc2_tl.cu's sweep,
# as the streamed-increment one before it) runs built with -fmad=false
# (kernels/build.py, NO_FMA): with nvcc's FMA contraction it sat
# 2.73-3.28e-6 from jvp of the truth path in f32 on an NVIDIA H100 80GB HBM3
# (the contracted multiply-adds against eager PyTorch's separately rounded
# ones), without it 1.412e-7 (PERF.md section 6).  A damp site broken on the
# tangent path shows above 1e-4.
PALLAS_TL_PARITY_TOL = 1.0e-6


def _identity_parts(inputs, dout, adj, params, dscale: float):
    """One lane's ``[<Mdx, Mdx>, <dx, M^T M dx>, non-finite leaves, terms]``
    as a float64 tensor on its device."""
    import torch

    w = [1.0] * len(dout)
    if hasattr(dout, "rfln"):  # the 8-stream contract
        w[6:] = [1.0 + float(params.yomcst.rlvtt) ** 2,
                 1.0 + float(params.yomcst.rlstt) ** 2]
    n1 = sum(wi * x.double().square().sum() for wi, x in zip(w, dout))
    n2 = sum((dscale * x.double() * a.double()).sum()
             for x, a in zip(inputs, adj))
    bad = torch.stack([~torch.isfinite(x).all() for x in (*dout, *adj)]).sum()
    return torch.stack([n1, n2, bad.double(),
                        torch.full_like(n1, float(inputs.pt.numel()))])


def adjoint_identity(inputs, dout, adj, params, dscale: float, mesh=None):
    """Adjoint identity <Mdx, Mdx> vs <dx, M^T M dx> with dx = dscale·x
    (cloudsc_driver_ad_mod.F90:184-264).  On the 8-stream contract the flux
    seeds' (1 + L²) fold is restored in the norm; on the standard 10-field
    contract every field counts once (cloudsc2jax/cli.py:229-239).  Sums run
    on the device in float64, per stream; only the two totals and the
    finiteness flag reach the host.  With a ``mesh`` (``dist.ColumnMesh``)
    the three arguments are lists with one entry per local lane, and the
    sums are reduced over the lanes and the ranks.  Returns ``(rel_err,
    finite)``."""
    return _identity(inputs, dout, adj, params, dscale, mesh)[:2]


def _identity(inputs, dout, adj, params, dscale: float, mesh):
    """:func:`adjoint_identity` and the number of its terms."""
    if mesh is None:
        parts = _identity_parts(inputs, dout, adj, params, dscale).tolist()
    else:
        parts = mesh.reduce([_identity_parts(i, d, a, params, dscale)
                             for i, d, a in zip(inputs, dout, adj)], "sum").tolist()
    n1, n2, bad, n_terms = parts
    return abs(n1 - n2) / max(abs(n2), 1e-300), bad == 0, int(n_terms)


def _parity_parts(inputs, dout, params, *, lregcl: bool):
    """One lane's ``(2, 10)``: per field max |kernel - jvp| and max |jvp|."""
    import torch

    from .drivers import DSCALE
    from .physics.cloudsc2 import Cloudsc2Inputs
    from .tlad import cloudsc2_tl

    d_inputs = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
    _, dref = cloudsc2_tl(inputs, d_inputs, params, lregcl=lregcl)
    return torch.stack([torch.stack([(a - b).abs().max() for a, b in zip(dout, dref)]),
                        torch.stack([b.abs().max() for b in dref])])


def tl_parity(inputs, dout, params, *, lregcl: bool, mesh=None) -> float:
    """Max relative error, over the 10 fields, of the TL kernel's tangents
    ``dout`` against ``torch.func.jvp`` of the truth path on the same
    inputs with the canonical increments (cloudsc2jax/cli.py:307).  With a
    ``mesh``, ``inputs`` and ``dout`` hold one entry per local lane; each
    field's two maxima are reduced over the lanes and the ranks before the
    ratio."""
    if mesh is None:
        parts = _parity_parts(inputs, dout, params, lregcl=lregcl)
    else:
        parts = mesh.reduce([_parity_parts(i, d, params, lregcl=lregcl)
                             for i, d in zip(inputs, dout)], "max")
    return float((parts[0] / parts[1].clamp_min(1e-30)).max())


def measure_f32_verdicts(state, inputs, *, lregcl: bool = True, mesh=None) -> dict:
    """Measured (tl_parity, ad_identity) relative errors through the TL and
    AD kernels on the standard contract, on ``inputs`` cast to f32: the
    quantities the ``--kernels`` verdicts gate on, with their tolerances
    (cloudsc2jax/cli.py:331).  With a ``mesh``, ``inputs`` holds one input
    per local lane and the verdicts are those of all columns of the
    group."""
    import torch

    from .drivers import DSCALE, run_tlad
    from .physics.cloudsc2 import Cloudsc2Inputs

    def f32(x):
        return Cloudsc2Inputs(*(y.to(torch.float32) for y in x))

    i32 = f32(inputs) if mesh is None else [f32(x) for x in inputs]
    res = run_tlad(i32, state.params, lregcl=lregcl, backend="kernels", mesh=mesh)
    _, dout, adj = res if mesh is None else zip(*res)
    identity, finite, n_terms = _identity(i32, dout, adj, state.params, DSCALE, mesh)
    parity = tl_parity(i32, dout, state.params, lregcl=lregcl, mesh=mesh)
    return {"tl_parity_rel_err": parity, "ad_identity_rel_err": identity,
            "finite": finite, "tl_parity_tol": PALLAS_TL_PARITY_TOL,
            "ad_identity_tol": scaled_identity_tol(PALLAS_AD_IDENTITY_TOL, n_terms)}


def _kernels_f32_check(variant: str, state, inputs, *, lregcl: bool,
                       mesh, rank0: bool) -> bool:
    """The check behind ``tl --kernels`` / ``ad --kernels``
    (cloudsc2jax/cli.py:354).  The f32 Taylor sweep floors above the
    reference's 1e-5 hard limit, so the f32 story of the kernels is (a) TL
    parity against ``jvp`` of the truth path on identical f32 inputs and
    (b) the adjoint identity through the TL and AD kernels."""
    import math

    inputs, kw = _lane_args(mesh, inputs)
    v = measure_f32_verdicts(state, inputs, lregcl=lregcl, **kw)
    where = "" if mesh.device_type == "cuda" else ", plain versions"
    if variant == "tl":
        rel, tol = v["tl_parity_rel_err"], v["tl_parity_tol"]
        ok = math.isfinite(rel) and rel < tol
        line = (f" TL(kernels) vs jvp parity [f32{where}]: max rel err "
                f"{rel:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAILED'}")
    else:
        rel, tol = v["ad_identity_rel_err"], v["ad_identity_tol"]
        ok = v["finite"] and rel < tol
        line = (f" AD(kernels) identity <Mdx,Mdx> vs <dx,M^TMdx> [f32{where}]: "
                f"rel err {rel:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAILED'}")
    if rank0:
        print(line, file=sys.stderr)
    return ok


def _lane_args(mesh, inputs):
    """The drivers' inputs and ``mesh`` keyword for ``inputs``, one per
    lane: one lane of one process calls them as on one device."""
    if mesh.size == 1:
        return inputs[0], {}
    return inputs, {"mesh": mesh}


def _close_spmd_timing(timer, args, mesh, ngptot, ngpblks, *, calls: int,
                       measure=None) -> None:
    """Each process logs its lanes' share of the columns, lane 0's clock
    mirrored to its other lanes, and prints the table, gathered over the
    ranks (timer_mod.F90:155's MPI_GATHER; cloudsc2jax/cli.py:417-448).
    ``measure=(step, per_lane_inputs)`` (``--per-device-timing``) replaces
    the mirrored clocks with each lane's own, re-timed on its device after
    the global clock has closed."""
    rank0 = mesh.rank == 0
    timer.spmd_log(mesh.nlanes, (ngptot // mesh.world) * calls)
    timer.thread_end(0)
    timer.mirror_times(mesh.nlanes)
    timer.end()
    if measure is not None:
        if mesh.size > 1:
            timer.measure_device_lanes(*measure, calls_equivalent=calls)
        elif rank0:
            print("--per-device-timing needs a multi-device or multi-process "
                  "run — ignored", file=sys.stderr)
    timer.print_performance(args.nproma, ngpblks, ngptot, gather=True)


def _run_test(args, state, inputs, timer, ngptot, ngpblks, mesh) -> int:
    """The ``tl`` and ``ad`` variants (cloudsc2jax/cli.py:534-580), each rank
    on its own columns, the norms reduced over the group."""
    from .drivers import adjoint_test, taylor_test

    rank0 = mesh.rank == 0
    x, kw = _lane_args(mesh, inputs)
    timer.thread_start(0)
    if args.variant == "tl":
        res = taylor_test(x, state.params, nproma=args.nproma, lregcl=False, **kw)
    else:
        # --threshold is in working-precision epsilons here too (the AD
        # criterion is 1e4 x eps upstream, cloudsc_driver_ad_mod.F90:289)
        thr = args.threshold if args.threshold is not None else 1.0e4
        res = adjoint_test(x, state.params, lregcl=True, threshold=thr, **kw)
    # columns are logged once for the whole test (the Taylor ladder is 11 NL
    # + 1 TL evaluations), as the reference TL driver logs them once per
    # block around its ladder (cloudsc_driver_tl_mod.F90:257)
    _close_spmd_timing(timer, args, mesh, ngptot, ngpblks, calls=1)
    if rank0:
        res.report()
    if args.variant == "tl" and not res.passed and args.dtype != "f64" and rank0:
        print(
            " NOTE: the Taylor test is an f64 diagnostic; in f32 the "
            "lambda sweep floors above the\n reference's 1e-5 hard limit "
            "(as for the reference's own -DSINGLE build).\n"
            " Run with --dtype f64 for the validation-precision verdict.",
            file=sys.stderr,
        )
    ok = res.passed
    if args.kernels:
        if mesh.device_type != "cuda" and rank0:
            print("NOTE: --kernels on --device cpu runs the kernels' plain "
                  "PyTorch versions", file=sys.stderr)
        ok = _kernels_f32_check(args.variant, state, inputs, mesh=mesh,
                                rank0=rank0, lregcl=args.variant == "ad") and ok
    return 0 if ok else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    import torch

    from . import dist

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    # the process group before any device work (≙ CLOUDSC_MPI_INIT); a
    # caller that made the group keeps it
    owns_group = dist.initialize()
    try:
        return _main(args)
    finally:
        if owns_group:
            dist.finalize()


def _main(args) -> int:
    import torch

    from . import dist
    from .state import Cloudsc2State
    from .timer import PerformanceTimer

    device = torch.device(args.device)
    try:
        mesh = dist.column_mesh(device, args.numdev)
    except ValueError as e:
        raise SystemExit(f"cloudsc2jax_torch: numdev {args.numdev}: {e}")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    input_path = pathlib.Path(args.input or _FIXTURES / "input.npz")
    reference_path = pathlib.Path(args.reference or _FIXTURES / "reference.npz")

    ngptot = dist.pad_columns(args.ngptot, mesh)
    ngpblks = -(-ngptot // args.nproma)
    state = (
        Cloudsc2State.load(input_path)
        if input_path.exists()
        else Cloudsc2State.synthetic(ngptot=min(ngptot, 100))
    )
    state.ngptot = ngptot
    if args.levapls2:
        state.params = state.params.replace(
            yophnc=dataclasses.replace(state.params.yophnc, levapls2=True))
    tlad = args.variant == "tlad"
    streams = args.kernels and args.variant in ("nl", "tlad")
    # each lane expands its own global columns on its device (the per-rank
    # hyperslab, expand_mod.F90:30-46)
    slices = dist.lane_slices(ngptot, mesh)
    if streams:
        inputs = [state.device_kernel_inputs(s.stop - s.start, dtype=dtype,
                                             device=dev, pqs=tlad,
                                             col_offset=s.start)
                  for dev, s in zip(mesh.lanes, slices)]
    else:
        inputs = [state.device_inputs(s.stop - s.start, dtype=dtype, device=dev,
                                      col_offset=s.start)
                  for dev, s in zip(mesh.lanes, slices)]
    if mesh.rank == 0:
        print(
            f"     NUMPROC={mesh.world}, NUMDEV={mesh.nlanes}, NGPTOTG={ngptot},"
            f" NPROMA={args.nproma}, NGPBLKS={ngpblks}",
            file=sys.stderr,
        )

    timer = PerformanceTimer(mesh.lanes)
    timer.start(mesh.nlanes)
    with profiled(args.profile, device):
        return _dispatch(args, state, inputs, timer, ngptot, ngpblks,
                         reference_path, streams, mesh, slices[0].start)


def _dispatch(args, state, inputs, timer, ngptot, ngpblks, reference_path,
              streams, mesh, col_offset) -> int:
    """Run the variant and its checks; returns the exit code, the same on
    every rank."""
    from functools import partial

    from .drivers import DSCALE, run_nl, run_tlad
    from .kernels.cloudsc2_kernel import unblock_outputs

    if args.variant in ("tl", "ad"):
        return _run_test(args, state, inputs, timer, ngptot, ngpblks, mesh)
    rank0 = mesh.rank == 0
    tlad = args.variant == "tlad"
    if tlad and streams:
        step = partial(run_tlad, params=state.params, lregcl=True)
    elif tlad:
        # each lane's columns in NPROMA blocks (cloudsc2jax/cli.py:582-601)
        step = partial(run_tlad, params=state.params, lregcl=True, backend="truth",
                       nproma=args.nproma if args.nproma < ngptot else None)
    else:
        step = partial(run_nl, params=state.params,
                       backend="streams" if streams else "truth")
    timer.thread_start(0)
    for _ in range(args.repeat):
        out = step(inputs, mesh=mesh)
    _close_spmd_timing(timer, args, mesh, ngptot, ngpblks, calls=args.repeat,
                       measure=(step, inputs) if args.per_device_timing else None)

    if tlad:
        _, dout, adj = zip(*out)
        rel, finite = adjoint_identity(inputs, dout, adj, state.params, DSCALE,
                                       mesh=mesh)
        # f64: 1e-10 ~ 1e4 eps64, the reference's semantics; f32: the
        # kernels' budget, or one decade more for the truth path and the
        # plain versions (the JAX package's jvp/vjp pair), scaled with the
        # reduction length (cloudsc2jax/cli.py:612-620)
        n_terms = ngptot * state.params.nlev
        kernels = streams and mesh.device_type == "cuda"
        tol = (1e-10 if args.dtype == "f64" else scaled_identity_tol(
            PALLAS_AD_IDENTITY_TOL if kernels else 1e-5, n_terms))
        ok = finite and rel < tol
        if rank0:
            print(f"tlad outputs finite: {finite}; adjoint identity rel err: "
                  f"{rel:.3e} (tol {tol:g})", file=sys.stderr)
        return 0 if ok else 1

    validate = not args.no_validate and reference_path.exists()
    write_reference = os.environ.get("CLOUDSC2_WRITE_REFERENCE") == "1"
    ok = True
    if streams and (validate or write_reference):
        # the (ncol, nlev) contract, assembled once, outside the timing
        out = mesh.map(partial(unblock_outputs, params=state.params), out)
    if validate:
        if not streams:
            # validate_device reads the levels-major tensors behind the views
            inputs = [type(x)(*(y.T for y in x)) for x in inputs]
        ok = state.validate_device(
            out, inputs, reference_path,
            threshold=10.0 if args.threshold is None else args.threshold,
            quiet=not rank0, mesh=mesh, col_offset=col_offset)
    if write_reference:
        if mesh.world > 1:
            # golden writing is a one-process, 100-column operation upstream
            # too (WRITE_REFERENCE requires NPROMA == KLON,
            # cloudsc2_array_state_mod.F90:264-268)
            if rank0:
                print("CLOUDSC2_WRITE_REFERENCE ignored in multi-process runs; "
                      "rerun single-process", file=sys.stderr)
        else:
            # the stored columns suffice (cyclic expansion); only they reach
            # the host, from the lanes in order
            state.write_reference(_first_columns(out, state.klon_file),
                                  WRITTEN_REFERENCE)
            print(f"Written reference results to {WRITTEN_REFERENCE}",
                  file=sys.stderr)
    return 0 if ok else 1


def _first_columns(per_lane, ncol: int):
    """The first ``ncol`` columns of the lanes' ``(ncol, ...)`` outputs, the
    lanes in order (all of a lane's when one lane holds them)."""
    import torch

    if per_lane[0].pclc.shape[0] >= ncol or len(per_lane) == 1:
        return per_lane[0]
    return type(per_lane[0])(*(torch.cat([x.cpu() for x in xs])[:ncol]
                               for xs in zip(*per_lane)))


if __name__ == "__main__":
    raise SystemExit(main())
