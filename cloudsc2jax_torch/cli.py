"""Command-line entry points on one GPU.

Port of the ``nl`` and ``tlad`` variants of :mod:`cloudsc2jax.cli`
(reference ``src/cloudsc2_{nl,ad}/dwarf_cloudsc.F90``)::

    python -m cloudsc2jax_torch nl <numdev> <ngptot> <nproma>
    python -m cloudsc2jax_torch tlad <numdev> <ngptot> <nproma>

``numdev`` must be 1.  ``nproma`` is kept for the reporting table (the
kernels own one column per thread).  The input is expanded on the device.
``nl`` runs the fused SATUR+CLOUDSC2 sweep ``--repeat`` times and validates
the outputs on the device against the golden file.  ``tlad`` runs the TL+AD
work unit (``drivers.run_tlad``, LREGCL on) ``--repeat`` times and checks
the adjoint identity <Mdx, Mdx> = <dx, M^T M dx> with dx = DSCALE·x.
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
        description="CLOUDSC2 NL and TL+AD drivers on one CUDA device "
                    "(PyTorch port)",
    )
    p.add_argument("variant", choices=["nl", "tlad"],
                   help="nl mirrors the reference's nonlinear dwarf; tlad "
                        "runs the TL+AD production work unit")
    p.add_argument("numdev", type=int, nargs="?", default=1,
                   help="number of devices to use; must be 1")
    p.add_argument("ngptot", type=int, nargs="?", default=100)
    p.add_argument("nproma", type=int, nargs="?", default=100,
                   help="block size for reporting")
    p.add_argument("--input", default=None,
                   help="input store (.npz or .h5; default: bundled fixture)")
    p.add_argument("--reference", default=None,
                   help="golden store for NL validation (.npz or .h5)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--dtype", choices=["f64", "f32"], default="f64",
                   help="working precision (JPRB double / -DSINGLE analogue)")
    p.add_argument("--repeat", type=int, default=1, help="benchmark repetitions")
    p.add_argument("--threshold", type=float, default=10.0,
                   help="nl validation tolerance in units of the working "
                        "precision's machine epsilon (validate_mod.F90:"
                        "285-289); f32 runs validate at 1e4")
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


def adjoint_identity(inputs, dout, adj, params, dscale: float):
    """Adjoint identity <Mdx, Mdx> vs <dx, M^T M dx> with dx = dscale·x
    (cloudsc_driver_ad_mod.F90:184-264), on the 8-stream contract: the flux
    seeds' (1 + L²) fold is restored in the norm.  Sums run on the device in
    float64, per stream; only the two totals and the finiteness flag reach
    the host.  Returns ``(rel_err, finite)``."""
    import torch

    w = [1.0] * 6 + [1.0 + float(params.yomcst.rlvtt) ** 2,
                     1.0 + float(params.yomcst.rlstt) ** 2]
    n1 = sum(wi * x.double().square().sum() for wi, x in zip(w, dout))
    n2 = sum((dscale * x.double() * a.double()).sum()
             for x, a in zip(inputs, adj))
    finite = torch.stack([torch.isfinite(x).all() for x in (*dout, *adj)]).all()
    n1, n2, finite = torch.stack([n1, n2, finite.double()]).tolist()
    return abs(n1 - n2) / max(abs(n2), 1e-300), bool(finite)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.numdev != 1:
        raise SystemExit("cloudsc2jax_torch runs on one device: numdev must be 1")

    import torch

    from .drivers import DSCALE, run_nl, run_tlad
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
    inputs = state.device_kernel_inputs(ngptot, dtype=dtype, device=device,
                                        pqs=tlad)
    print(
        f"     NUMPROC=1, NUMDEV=1, NGPTOTG={ngptot}, NPROMA={args.nproma},"
        f" NGPBLKS={ngpblks}",
        file=sys.stderr,
    )

    timer = PerformanceTimer(device)
    timer.start(1)
    timer.thread_start(0)
    for _ in range(args.repeat):
        out = (run_tlad(inputs, state.params, lregcl=True) if tlad
               else run_nl(inputs, state.params))
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
        ok = state.validate_device(out, inputs, reference_path,
                                   threshold=args.threshold)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
