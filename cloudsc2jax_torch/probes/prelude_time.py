"""The prelude's kernel against its plain expression on one CUDA card.

Run from the root of a checkout::

    python3 cloudsc2jax_torch/probes/prelude_time.py [NCOL]

At NCOL columns (default 327,680) of the dwarf's stored columns tiled, f32
and f64, four input sets (pt and ten_t, and three rolled copies, so that no
call finds its rows in L2): the tropopause eta of ``kernel_prelude``'s kernel
(``csrc/cloudsc2_prelude.cu``) bit for bit against the plain expression
``tropopause_eta_lm(pt + ptsphy*ten_t, ceta)`` on every set, then ms a call
of each, 200 calls between two CUDA events, in turns (plain, kernel,
kernel, plain), where the kernel's calls may wait for the host's Python;
the kernel's own device time under ``torch.profiler`` over 100 calls; its
bytes (the hull's rows of pt and ten_t read once, ztrpaus written) and its
least time at 3.35 TB/s, against the profiler's time; ptxas' registers.
One JSON line on standard output with the card's name and power limit;
exit 2 without a card, 1 if a set differs.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
PEAK_BYTES_PER_S = 3.35e12


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _ms(torch, fn, sets, calls: int = 200) -> float:
    for s in sets:
        fn(s)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(calls):
        fn(sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _device_ms(torch, runs, calls: int = 100) -> dict:
    """Device ms per launch of the prelude's kernel, per dtype, in one
    profiler session (a second session in one process may trace no kernel):
    ``runs`` maps a dtype's name to ``(fn, sets)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, sets in runs.values():
            for i in range(calls):
                fn(sets[i % len(sets)])
        torch.cuda.synchronize()
    out = {}
    for name in runs:
        found = [e for e in prof.key_averages()
                 if f"cloudsc2_prelude_kernel<{name}>" in e.key]
        count = sum(e.count for e in found)
        out[name] = (sum(e.device_time_total for e in found) / count / 1e3
                     if count else None)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("prelude_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.state import Cloudsc2State

    ncol = int(argv[0]) if argv else 327_680
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    record = {"card": _card(), "torch": torch.__version__, "ncol": ncol}
    ok = True
    runs = {}
    for dtype, name in ((torch.float32, "float"), (torch.float64, "double")):
        x = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda")
        none = km.Cloudsc2Inputs(*(None for _ in km.Cloudsc2Inputs._fields))
        # the prelude reads pt, ten_t and paph's surface row only
        sets = [none._replace(pt=x.pt.roll(s, dims=1), ten_t=x.ten_t.roll(s, dims=1),
                              paph=x.paph) for s in (0, 37, 71, 113)]
        del x
        ceta, _ = km.level_scalars(p, sets[0].pt)

        def plain(x, ceta=ceta):
            return km.tropopause_eta_lm(x.pt + p.ptsphy * x.ten_t, ceta)

        def kernel(x):
            return km.kernel_prelude(x, p).ztrpaus

        launches = km.kernel_prelude.launches
        same = all(torch.equal(kernel(x), plain(x)) for x in sets)
        torch.cuda.synchronize()
        ok &= same and km.kernel_prelude.launches == launches + len(sets)
        turns = [_ms(torch, f, sets) for f in (plain, kernel, kernel, plain)]
        k_lo, k_hi = km.tropopause_hull(p, dtype)
        nbytes = (2 * (k_hi - k_lo + 2) + 1) * ncol * sets[0].pt.element_size()
        record[name] = {
            "bit_for_bit": same, "hull": [k_lo, k_hi],
            "plain_ms": [turns[0], turns[3]], "kernel_call_ms": [turns[1], turns[2]],
            "bytes": nbytes, "least_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        }
        runs[name] = (kernel, sets)
    for name, ms in _device_ms(torch, runs).items():
        record[name]["device_ms"] = ms
        record[name]["roofline_pct"] = (None if ms is None
                                        else 100.0 * record[name]["least_ms"] / ms)
    record["ptxas"] = build.ptxas_report("cloudsc2_prelude")
    record["ok"] = ok
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
