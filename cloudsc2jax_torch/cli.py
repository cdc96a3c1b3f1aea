"""Command-line entry points on one GPU.

Port of :mod:`cloudsc2jax.cli` on one device (reference
``src/cloudsc2_{nl,tl,ad}/dwarf_cloudsc.F90``)::

    python -m cloudsc2jax_torch nl <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch tl <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch ad <numdev> <ngptot> <nproma> [--kernels]
    python -m cloudsc2jax_torch tlad <numdev> <ngptot> <nproma>

``numdev`` must be 1.  ``nproma`` is the block size of the Taylor test's
statistics and of the reporting table (the kernels own one column per
thread).  The input is expanded on the device.

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
  M dx> with dx = DSCALE·x.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

_FIXTURES = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"


def _build_parser():
    p = argparse.ArgumentParser(
        prog="cloudsc2jax_torch",
        description="CLOUDSC2 NL, TL, AD and TL+AD drivers on one CUDA "
                    "device (PyTorch port)",
    )
    p.add_argument("variant", choices=["nl", "tl", "ad", "tlad"],
                   help="nl/tl/ad mirror the three reference dwarfs; tlad "
                        "runs the TL+AD production work unit")
    p.add_argument("numdev", type=int, nargs="?", default=1,
                   help="number of devices to use; must be 1")
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
                   help="nl: run the CUDA kernel on the stream contract "
                        "instead of the truth path; tl/ad: add the f32 "
                        "verdict through the CUDA kernels on the standard "
                        "contract (their plain versions with --device cpu)")
    p.add_argument("--threshold", type=float, default=None,
                   help="tolerance in units of the working precision's "
                        "machine epsilon; defaults per variant: 10 for nl "
                        "validation (validate_mod.F90:285-289; f32 runs "
                        "validate at 1e4), 1e4 for the ad symmetry test "
                        "(cloudsc_driver_ad_mod.F90:289)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the CUDA kernels; cpu runs their plain "
                        "PyTorch versions")
    return p


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
# it is not scaled.  The JAX package gates its Pallas TL at 1e-6
# (cloudsc2jax/cli.py:288).  This card needs 1e-5: on an NVIDIA H100 80GB
# HBM3 the TL kernel sits 3.277e-6 (lregcl off) and 2.731e-6 (on) from jvp
# of the truth path in f32, at 100 and at 16,384 columns alike, while both
# f32 versions sit 1.568e-5 from the truth path in f64, to four digits the
# same.  The gap between the two f32 versions is nvcc's FMA contraction
# against eager PyTorch's separately rounded multiply and add: built with
# -fmad=false the same kernel sits 1.412e-7 from the f32 truth path, no
# closer to f64, and runs 3-5% slower (PERF.md section 6).  A damp site
# broken on the tangent path shows above 1e-4, so 1e-5 still trips on it.
PALLAS_TL_PARITY_TOL = 1.0e-5


def adjoint_identity(inputs, dout, adj, params, dscale: float):
    """Adjoint identity <Mdx, Mdx> vs <dx, M^T M dx> with dx = dscale·x
    (cloudsc_driver_ad_mod.F90:184-264).  On the 8-stream contract the flux
    seeds' (1 + L²) fold is restored in the norm; on the standard 10-field
    contract every field counts once (cloudsc2jax/cli.py:229-239).  Sums run
    on the device in float64, per stream; only the two totals and the
    finiteness flag reach the host.  Returns ``(rel_err, finite)``."""
    import torch

    w = [1.0] * len(dout)
    if hasattr(dout, "rfln"):  # the 8-stream contract
        w[6:] = [1.0 + float(params.yomcst.rlvtt) ** 2,
                 1.0 + float(params.yomcst.rlstt) ** 2]
    n1 = sum(wi * x.double().square().sum() for wi, x in zip(w, dout))
    n2 = sum((dscale * x.double() * a.double()).sum()
             for x, a in zip(inputs, adj))
    finite = torch.stack([torch.isfinite(x).all() for x in (*dout, *adj)]).all()
    n1, n2, finite = torch.stack([n1, n2, finite.double()]).tolist()
    return abs(n1 - n2) / max(abs(n2), 1e-300), bool(finite)


def tl_parity(inputs, dout, params, *, lregcl: bool) -> float:
    """Max relative error, over the 10 fields, of the TL kernel's tangents
    ``dout`` against ``torch.func.jvp`` of the truth path on the same
    inputs with the canonical increments (cloudsc2jax/cli.py:307)."""
    import torch

    from .drivers import DSCALE
    from .physics.cloudsc2 import Cloudsc2Inputs
    from .tlad import cloudsc2_tl

    d_inputs = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
    _, dref = cloudsc2_tl(inputs, d_inputs, params, lregcl=lregcl)
    rels = [(a - b).abs().max() / torch.clamp_min(b.abs().max(), 1e-30)
            for a, b in zip(dout, dref)]
    return float(torch.stack(rels).max())


def measure_f32_verdicts(state, inputs, *, lregcl: bool = True) -> dict:
    """Measured (tl_parity, ad_identity) relative errors through the TL and
    AD kernels on the standard contract, on ``inputs`` cast to f32: the
    quantities the ``--kernels`` verdicts gate on, with their tolerances
    (cloudsc2jax/cli.py:331)."""
    import torch

    from .drivers import DSCALE, run_tlad
    from .physics.cloudsc2 import Cloudsc2Inputs

    i32 = Cloudsc2Inputs(*(x.to(torch.float32) for x in inputs))
    _, dout, adj = run_tlad(i32, state.params, lregcl=lregcl, backend="kernels")
    parity = tl_parity(i32, dout, state.params, lregcl=lregcl)
    identity, finite = adjoint_identity(i32, dout, adj, state.params, DSCALE)
    return {"tl_parity_rel_err": parity, "ad_identity_rel_err": identity,
            "finite": finite, "tl_parity_tol": PALLAS_TL_PARITY_TOL,
            "ad_identity_tol": scaled_identity_tol(PALLAS_AD_IDENTITY_TOL,
                                                   i32.pt.numel())}


def _kernels_f32_check(variant: str, state, inputs, *, lregcl: bool) -> bool:
    """The check behind ``tl --kernels`` / ``ad --kernels``
    (cloudsc2jax/cli.py:354).  The f32 Taylor sweep floors above the
    reference's 1e-5 hard limit, so the f32 story of the kernels is (a) TL
    parity against ``jvp`` of the truth path on identical f32 inputs and
    (b) the adjoint identity through the TL and AD kernels."""
    import math

    v = measure_f32_verdicts(state, inputs, lregcl=lregcl)
    where = "" if inputs.pt.device.type == "cuda" else ", plain versions"
    if variant == "tl":
        rel, tol = v["tl_parity_rel_err"], v["tl_parity_tol"]
        ok = math.isfinite(rel) and rel < tol
        print(f" TL(kernels) vs jvp parity [f32{where}]: max rel err "
              f"{rel:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAILED'}",
              file=sys.stderr)
    else:
        rel, tol = v["ad_identity_rel_err"], v["ad_identity_tol"]
        ok = v["finite"] and rel < tol
        print(f" AD(kernels) identity <Mdx,Mdx> vs <dx,M^TMdx> [f32{where}]: "
              f"rel err {rel:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAILED'}",
              file=sys.stderr)
    return ok


def _run_test(args, state, inputs, timer, ngptot, ngpblks) -> int:
    """The ``tl`` and ``ad`` variants (cloudsc2jax/cli.py:534-580)."""
    from .drivers import adjoint_test, taylor_test

    timer.thread_start(0)
    if args.variant == "tl":
        res = taylor_test(inputs, state.params, nproma=args.nproma, lregcl=False)
    else:
        # --threshold is in working-precision epsilons here too (the AD
        # criterion is 1e4 x eps upstream, cloudsc_driver_ad_mod.F90:289)
        thr = args.threshold if args.threshold is not None else 1.0e4
        res = adjoint_test(inputs, state.params, lregcl=True, threshold=thr)
    # columns are logged once for the whole test (the Taylor ladder is 11 NL
    # + 1 TL evaluations), as the reference TL driver logs them once per
    # block around its ladder (cloudsc_driver_tl_mod.F90:257)
    timer.thread_log(0, ngptot)
    timer.thread_end(0)
    timer.end()
    timer.print_performance(args.nproma, ngpblks, ngptot)
    res.report()
    if args.variant == "tl" and not res.passed and args.dtype != "f64":
        print(
            " NOTE: the Taylor test is an f64 diagnostic; in f32 the "
            "lambda sweep floors above the\n reference's 1e-5 hard limit "
            "(as for the reference's own -DSINGLE build).\n"
            " Run with --dtype f64 for the validation-precision verdict.",
            file=sys.stderr,
        )
    ok = res.passed
    if args.kernels:
        if inputs.pt.device.type != "cuda":
            print("NOTE: --kernels on --device cpu runs the kernels' plain "
                  "PyTorch versions", file=sys.stderr)
        ok = _kernels_f32_check(args.variant, state, inputs,
                                lregcl=args.variant == "ad") and ok
    return 0 if ok else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.numdev != 1:
        raise SystemExit("cloudsc2jax_torch runs on one device: numdev must be 1")
    if args.kernels and args.variant == "tlad":
        raise SystemExit("--kernels applies to the nl, tl and ad variants")

    import torch

    from .drivers import DSCALE, run_nl, run_tlad
    from .kernels.cloudsc2_kernel import unblock_outputs
    from .state import Cloudsc2State
    from .timer import PerformanceTimer

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    input_path = pathlib.Path(args.input or _FIXTURES / "input.npz")
    reference_path = pathlib.Path(args.reference or _FIXTURES / "reference.npz")

    ngptot = args.ngptot
    ngpblks = -(-ngptot // args.nproma)
    state = (
        Cloudsc2State.load(input_path)
        if input_path.exists()
        else Cloudsc2State.synthetic(ngptot=min(ngptot, 100))
    )
    state.ngptot = ngptot
    tlad = args.variant == "tlad"
    streams = tlad or args.kernels and args.variant == "nl"
    if streams:
        inputs = state.device_kernel_inputs(ngptot, dtype=dtype, device=device,
                                            pqs=tlad)
    else:
        inputs = state.device_inputs(ngptot, dtype=dtype, device=device)
    print(
        f"     NUMPROC=1, NUMDEV=1, NGPTOTG={ngptot}, NPROMA={args.nproma},"
        f" NGPBLKS={ngpblks}",
        file=sys.stderr,
    )

    timer = PerformanceTimer(device)
    timer.start(1)
    if args.variant in ("tl", "ad"):
        return _run_test(args, state, inputs, timer, ngptot, ngpblks)
    timer.thread_start(0)
    for _ in range(args.repeat):
        out = (run_tlad(inputs, state.params, lregcl=True) if tlad
               else run_nl(inputs, state.params,
                           backend="streams" if streams else "truth"))
        timer.thread_log(0, ngptot)
    timer.thread_end(0)
    timer.end()
    timer.print_performance(args.nproma, ngpblks, ngptot)

    if tlad:
        _, dout, adj = out
        rel, finite = adjoint_identity(inputs, dout, adj, state.params, DSCALE)
        # f64: 1e-10 ~ 1e4 eps64, the reference's semantics; f32: the
        # kernels' budget, or one decade more for the plain versions (the
        # JAX package's jvp/vjp pair), scaled with the reduction length
        tol = (1e-10 if args.dtype == "f64" else scaled_identity_tol(
            PALLAS_AD_IDENTITY_TOL if device.type == "cuda" else 1e-5,
            inputs.pt.numel()))
        ok = finite and rel < tol
        print(f"tlad outputs finite: {finite}; adjoint identity rel err: "
              f"{rel:.3e} (tol {tol:g})", file=sys.stderr)
        return 0 if ok else 1

    ok = True
    if not args.no_validate and reference_path.exists():
        if streams:
            # the (ncol, nlev) contract, assembled once, outside the timing
            out = unblock_outputs(out, state.params)
        else:
            # validate_device reads the levels-major tensors behind the views
            inputs = type(inputs)(*(x.T for x in inputs))
        ok = state.validate_device(
            out, inputs, reference_path,
            threshold=10.0 if args.threshold is None else args.threshold)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
