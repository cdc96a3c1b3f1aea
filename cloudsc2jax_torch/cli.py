"""Command-line entry point of the nonlinear dwarf on one GPU.

Port of the ``nl`` variant of :mod:`cloudsc2jax.cli` (reference
``src/cloudsc2_nl/dwarf_cloudsc.F90``)::

    python -m cloudsc2jax_torch nl <numdev> <ngptot> <nproma>

``numdev`` must be 1.  ``nproma`` is kept for the reporting table (the
kernel owns one column per thread).  The input is expanded on the device,
the fused SATUR+CLOUDSC2 sweep runs ``--repeat`` times, and the outputs are
validated on the device against the golden file.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

_FIXTURES = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"


def _build_parser():
    p = argparse.ArgumentParser(
        prog="cloudsc2jax_torch",
        description="CLOUDSC2 NL driver on one CUDA device (PyTorch port)",
    )
    p.add_argument("variant", choices=["nl"],
                   help="nl mirrors the reference's nonlinear dwarf")
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
                   help="validation tolerance in units of the working "
                        "precision's machine epsilon (validate_mod.F90:"
                        "285-289); f32 runs validate at 1e4")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the CUDA kernel; cpu runs its plain "
                        "PyTorch version")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.numdev != 1:
        raise SystemExit("cloudsc2jax_torch runs on one device: numdev must be 1")

    import torch

    from .drivers import run_nl
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
    inputs = state.device_kernel_inputs(ngptot, dtype=dtype, device=device)
    print(
        f"     NUMPROC=1, NUMDEV=1, NGPTOTG={ngptot}, NPROMA={args.nproma},"
        f" NGPBLKS={ngpblks}",
        file=sys.stderr,
    )

    timer = PerformanceTimer(device)
    timer.start(1)
    timer.thread_start(0)
    for _ in range(args.repeat):
        out = run_nl(inputs, state.params)
        timer.thread_log(0, ngptot)
    timer.thread_end(0)
    timer.end()
    timer.print_performance(args.nproma, ngpblks, ngptot)

    ok = True
    if not args.no_validate and reference_path.exists():
        ok = state.validate_device(out, inputs, reference_path,
                                   threshold=args.threshold)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
