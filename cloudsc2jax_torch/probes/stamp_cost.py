"""What the sweeps' stamped twins cost against their shipped instances, and
what their stamps read, for the instance each benchmark cell launches.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/stamp_cost.py [OUT.json] [NCOL]

Per instance (the NL sweep f32/f64, the TL sweep f32 without and with the
primal streams, the standard contract's build without FMA contraction, the
evaporating body and f64, the AD sweep f32, evaporating and f64), at NCOL
columns (327,680 by default) of the synthetic store: the shipped launch and
its twin (``spans.stamped`` patched to hand out a records buffer) issued in
turns, 20 rounds after two of each to warm, each timed by a pair of CUDA
events; the medians, the twin's cost in %, the shipped and the twin's
occupancy (``build.sweep_occupancy``) and the counters of the twin's last
launch (``spans.stamp_counters``), with the smallest nonzero step between
two warps' starts; then one launch under ``torch.profiler`` through the
spans, every call stamping, and its ``kernel_ms`` over its span's device
time.  One JSON line on standard output, also written to OUT.
"""

import json
import pathlib
import statistics
import sys


def main(argv) -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cloudsc2jax_torch import spans
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as ck
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.state import Cloudsc2State

    out_path = argv[1] if len(argv) > 1 else None
    ncol = int(argv[2]) if len(argv) > 2 else 327_680
    warps = -(-ncol // spans.SWEEP_THREADS) * (spans.SWEEP_THREADS // 32)
    records = torch.full((warps, spans.RECORD), -1, dtype=torch.int64, device="cuda")
    twin = {"on": False}
    traced = spans.stamped
    spans.STAMP_EVERY = 1
    spans.stamped = lambda entry, like, n: (
        (f"{entry}_stamped", (records,)) if twin["on"] else (entry, ()))
    st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
    props = torch.cuda.get_device_properties(0)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    cases = [("nl", d, False, None) for d in ("f32", "f64")]
    cases += [("tl", "f32", False, v) for v in ("noprim", "primal", "std")]
    cases += [("tl", "f32", True, "noprim"), ("tl", "f64", False, "noprim")]
    cases += [("ad", "f32", e, None) for e in (False, True)] + [("ad", "f64", False, None)]
    got = {"card": props.name, "sms": props.multi_processor_count, "ncol": ncol, "cases": {}}
    for kind, dtype, evap, variant in cases:
        x = st.device_kernel_inputs(ncol, dtype=dtypes[dtype], device="cuda",
                                    pqs=kind != "nl")
        pre = ck.kernel_prelude(x, st.params)
        if kind == "nl":
            lib, name, switches = ck._load_kernel(), "cloudsc2_nl", (int(evap),)
            launch = lambda: ck.launch_cloudsc2_nl(x, pre, st.params, ldrain1d=evap)  # noqa: E731
        elif kind == "tl":
            std = variant == "std"
            lib = tk._library("cloudsc2_tl", build.NO_FMA if std else ())
            name, switches = "cloudsc2_tl", (int(evap), 1, int(variant != "noprim"))
            if std:
                launch = lambda: tk.launch_cloudsc2_tl_std(  # noqa: E731
                    x, pre, st.params, dscale=0.01, ldrain1d=evap)
            else:
                launch = lambda: tk.launch_cloudsc2_tl(  # noqa: E731
                    x, pre, st.params, dscale=0.01, ldrain1d=evap,
                    write_primal=variant == "primal")
        else:
            _, dout, ckpts = tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01,
                                                   ldrain1d=evap, write_primal=False)
            lib, name, switches = tk._library("cloudsc2_ad"), "cloudsc2_ad", (int(evap), 1)
            launch = lambda: tk.launch_cloudsc2_ad(  # noqa: E731
                x, pre, dout, ckpts, st.params, ldrain1d=evap)
        times = {False: [], True: []}
        for i in range(22):
            for on in (False, True):
                twin["on"] = on
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                if i >= 2:
                    times[on].append(start.elapsed_time(end))
        ms = {on: statistics.median(t) for on, t in times.items()}
        stamps = records.cpu()
        starts = torch.unique(stamps[:, 0])
        occ = build.sweep_occupancy(lib, name, f"{name}_stamped", x.pt, *switches)
        patched, spans.stamped = spans.stamped, traced
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            launch()
            torch.cuda.synchronize()
        (rec,) = [r for r in spans.records() if r.name == f"{spans.PREFIX}{kind}_sweep"]
        spans.stamped = patched
        key = "/".join(str(v) for v in (kind, dtype, "evap" if evap else "", variant or "")
                       if v)
        got["cases"][key] = {
            "shipped_ms": ms[False], "twin_ms": ms[True],
            "cost_pct": 100.0 * (ms[True] / ms[False] - 1.0),
            "occupancy": occ,
            "stamps": spans.stamp_counters(stamps, props.multi_processor_count,
                                           occ["twin_blocks_per_sm"] * 4),
            "least_step_ns": int(starts.diff().min()) if len(starts) > 1 else None,
            "span_ms": rec.device_ms, "span_counters": rec.counters,
            "kernel_share_pct": 100.0 * rec.counters["kernel_ms"] / rec.device_ms}
        del x, pre, launch
        torch.cuda.empty_cache()
    line = json.dumps(got)
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
