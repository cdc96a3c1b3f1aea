"""Weak scaling over the lanes of a column mesh.

Port of ``tools/scaling_bench.py``::

    python -m cloudsc2jax_torch.scaling_bench [--devices N] [--percols 16384]
        [--variant nl|tlad] [--dtype f32|f64] [--repeats 10]
        [--device cuda|cpu] [--nlev 137]

For 1..N lanes at a fixed number of columns per lane, runs ``run_nl`` (the
stream contract) or ``run_tlad`` over a ``dist.ColumnMesh`` of that many
lanes, each lane expanding its own columns, and prints one JSON line per
lane count: columns/s and the parallel efficiency against one lane (the
reference's MPI scaling story: columns are independent and the kernels never
communicate, so the efficiency should be ~100% less the host's enqueue).
Each lane's calls get distinct inputs (``pt`` bumped) and chain through a
per-lane accumulator (``drivers.slice_probe``), read once after the timed
calls, under the host's clock.

On ``cuda`` the lanes are distinct cards: ``--devices`` (default: every
card) above the machine's cards is refused, and on a one-card machine only
N = 1 runs.  Two lanes that time-slice one card would measure nothing of
scaling, so no such run is offered.  ``--device cpu`` repeats CPU lanes over
the plain versions to exercise the decomposition: its numbers say nothing
about a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="cloudsc2jax_torch.scaling_bench",
                                 description="weak scaling over a column mesh")
    ap.add_argument("--devices", type=int, default=0,
                    help="largest lane count (0: every card; 1 on the CPU)")
    ap.add_argument("--percols", type=int, default=16384, help="columns per lane")
    ap.add_argument("--variant", choices=["nl", "tlad"], default="nl")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda runs the kernels on distinct cards; cpu the "
                         "plain versions on repeated CPU lanes")
    ap.add_argument("--nlev", type=int, default=137)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .dist import ColumnMesh
    from .drivers import run_nl, run_tlad, slice_probe
    from .state import Cloudsc2State

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("scaling_bench: --device cuda, but no CUDA device "
                             "is available")
        cards = torch.cuda.device_count()
        nmax = args.devices or cards
        if nmax > cards:
            raise SystemExit(
                f"scaling_bench: {nmax} lanes need {nmax} distinct cards; this "
                f"machine has {cards}" + (
                    ": on one card only N = 1 runs, and a time-sliced run of "
                    "several lanes on it would not be scaling" if cards == 1 else ""))
        if cards == 1:
            print("scaling_bench: one card, so N = 1 only: no scaling is "
                  "measured", file=sys.stderr)
    else:
        nmax = args.devices or 1
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    state = Cloudsc2State.synthetic(ngptot=100, nlev=args.nlev)
    tlad = args.variant == "tlad"
    if tlad:
        def fn(inputs, mesh):
            return run_tlad(inputs, state.params, lregcl=True, mesh=mesh)
    else:
        def fn(inputs, mesh):
            return run_nl(inputs, state.params, mesh=mesh)

    name = None
    if args.device == "cuda":
        from .bench import card

        name = card()

    results, base_rate = [], None
    for nd in range(1, nmax + 1):
        lanes = ([torch.device("cuda", i) for i in range(nd)]
                 if args.device == "cuda" else ["cpu"] * nd)
        mesh = ColumnMesh(lanes)
        inputs = [state.device_kernel_inputs(args.percols, dtype=dtype, device=dev,
                                             pqs=tlad, col_offset=lane * args.percols)
                  for lane, dev in enumerate(mesh.lanes)]
        calls = [[x._replace(pt=x.pt + 1e-6 * (i + 1)) for x in inputs]
                 for i in range(args.repeats)]

        def chain(batch):
            accs = [torch.zeros((), dtype=torch.float32, device=d) for d in mesh.lanes]
            for per_lane in batch:
                for lane, out in enumerate(fn(per_lane, mesh)):
                    accs[lane] = accs[lane] + slice_probe(out, args.variant)
            return float(sum(float(a) for a in accs))

        if not np.isfinite(chain(calls[: max(2, args.repeats // 4)])):  # warm
            raise AssertionError("scaling_bench: the warm-up chain is not finite")
        t0 = time.perf_counter()
        total = chain(calls)
        dt = (time.perf_counter() - t0) / args.repeats
        if not np.isfinite(total):
            raise AssertionError("scaling_bench: the timed chain is not finite")
        ng = args.percols * nd
        rate = ng / dt
        base_rate = base_rate or rate
        rec = {"devices": nd, "ngptot": ng, "variant": args.variant,
               "dtype": args.dtype, "cols_per_s": rate,
               "efficiency": rate / (base_rate * nd), "platform": args.device,
               "device_name": name and name["device_name"],
               "power_limit_w": name and name["power_limit_w"]}
        if args.device == "cpu":
            rec["note"] = ("plain PyTorch versions on repeated CPU lanes: not "
                           "a number of any card")
        print(json.dumps(rec), flush=True)
        results.append(rec)
        del inputs, calls
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
