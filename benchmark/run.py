"""Run one cell of the benchmark once, on the card it is started on.

    python3 -m benchmark.run --workload nl.stream --seed 7 --seconds 10 --trace 0

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit); the numbers compared are also the last lines of standard
error.  Exits non-zero, with no result, where the card or the system under
test is missing, and where JAX or the system's JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of PyTorch's own compilers at fixed paths inside the checkout
    # (the system builds its kernels into build/cloudsc2jax_torch there)
    cache = ROOT / "build" / "benchmark-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    from benchmark import harness

    try:
        result, checks, extra = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except harness.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 4
    print(f"calls {extra['calls']} in {extra['window_s']:.6f} s, call_ms median "
          f"{extra['call_ms_median']:.6f} over {extra['calls']} samples, "
          f"setup {extra['setup_s']:.6f} s, comparison {extra['check_s']:.1f} s, "
          f"card power limit {extra['power_limit']}",
          file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in extra["setup_parts"].items()),
          file=sys.stderr)
    print("widest gaps (shown, not compared): " + ", ".join(
        f"{k} {v:.6g}" for k, v in extra["widest"].items()), file=sys.stderr)
    for k, ch in checks.items():
        print(f"check {k}: {ch['value']:.6g} limit {ch['limit']:g}", file=sys.stderr)
    # a number that is not finite (a NaN or an infinity in the outputs) is null
    result["checks"] = {k: {"value": ch["value"] if math.isfinite(ch["value"]) else None,
                            "limit": ch["limit"]} for k, ch in checks.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
