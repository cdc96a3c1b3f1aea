"""What the port's spans cost, and what the profiler sees inside them.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/span_cost.py [OUT.json]

* Off (no profiler): nanoseconds per ``with spans.span(...)`` and per call
  of a ``spans.spanned`` function, against the bare body; under the
  profiler, microseconds per span and per piece of one (the
  ``record_function`` range, a CUDA event's record, the current stream).
* Per entry at 327,680 f32 columns (``run_nl`` and ``run_tlad`` on the
  stream and the standard contract, as the benchmark's cells drive them):
  200 calls back to back under ``torch.profiler``, each inside a
  ``bench.call`` range between two CUDA events as the benchmark's traced
  part issues them, in three modes: spans ``off`` (the module's check
  replaced), ``on``, and ``on`` with the host's clock in place of the CUDA
  events (``hostclock``).  Device busy ms and window ms a call and the idle
  share, host ms of 10 calls each issued to a drained device, the spans'
  summary, and (``on``) the launch calls inside each ``cloudsc2.*`` range
  against the increase of the wrappers' ``.launches*`` counters.
"""

import json
import os
import pathlib
import sys
import tempfile
import time

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _per_call_ns(fn, n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t) / n


def _off_cost(spans, torch) -> dict:
    like = torch.zeros(1)
    wrapped = spans.spanned("x")(lambda t: None)

    def with_span():
        with spans.span("x", like):
            pass

    n = 200_000
    return {"bare_call": _per_call_ns(lambda: (lambda t: None)(like), n),
            "spanned_call": _per_call_ns(lambda: wrapped(like), n),
            "bare_with": _per_call_ns(lambda: None, n),
            "with_span": _per_call_ns(with_span, n)}


def _on_cost(spans, torch) -> dict:
    """Microseconds per piece under the profiler (the caller's)."""
    dev = torch.device("cuda:0")
    like = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2000)]
    out = {}
    t = time.perf_counter_ns()
    for e in events:
        e.record(stream)
    out["event_create_record_us"] = (time.perf_counter_ns() - t) / len(events) / 1e3
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for e in events:
        e.record(stream)
    out["event_record_us"] = (time.perf_counter_ns() - t) / len(events) / 1e3

    def rf():
        with torch.profiler.record_function("x"):
            pass

    def span():
        with spans.span("x", like):
            pass

    out["record_function_us"] = _per_call_ns(rf, 2000) / 1e3
    out["current_stream_us"] = _per_call_ns(lambda: torch.cuda.current_stream(dev), 2000) / 1e3
    out["span_us"] = _per_call_ns(span, 2000) / 1e3
    torch.cuda.synchronize()
    spans.clear()
    return out


def _read_trace(path):
    """(device busy us, window us, launch calls inside each cloudsc2 range
    by range and launch name, launch calls, device operations)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat", "").lower() in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cur = 0.0, None
    for a, b in dev:
        if cur and a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [a, b]
    busy += cur[1] - cur[0]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("cloudsc2.")]
    launches = [float(e["ts"]) for e in events if e["name"] in LAUNCHES]
    inside = {}
    for ts in launches:
        for a, b, name in ranges:
            if a <= ts < b:
                inside[name] = inside.get(name, 0) + 1
    return busy, dev[-1][1] - dev[0][0], inside, len(launches), len(dev)


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cloudsc2jax_torch import drivers, spans
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": torch.cuda.get_device_name(0), "off_ns": _off_cost(spans, torch)}
    with profile(activities=activities):
        out["on_us"] = _on_cost(spans, torch)
    print("off_ns", out["off_ns"], "\non_us", out["on_us"], flush=True)

    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    lm = st.device_kernel_inputs(327_680, dtype=torch.float32, device="cuda", pqs=True)
    sets = [Cloudsc2Inputs(*(x.roll(k, dims=1) for x in lm)) for k in (0, 37, 74, 111)]
    views = [Cloudsc2Inputs(*(y.T for y in x)) for x in sets]
    entries = {
        "nl.stream": (lambda x: drivers.run_nl(x, p), [x._replace(pqs=None) for x in sets]),
        "nl.standard": (lambda x: drivers.run_nl(x, p, backend="kernels"),
                        [v._replace(pqs=None) for v in views]),
        "tlad.noprim": (lambda x: drivers.run_tlad(x, p, write_primal=False), sets),
        "tlad.primal": (lambda x: drivers.run_tlad(x, p), sets),
        "tlad.standard": (lambda x: drivers.run_tlad(x, p, backend="kernels"), views),
    }
    counters = [(km.cloudsc2_nl, "launches"), (km.cloudsc2_fwd_ckpt, "launches"),
                (tk.cloudsc2_tl, "launches"), (tk.cloudsc2_tl_din, "launches"),
                (tk.cloudsc2_ad, "launches")]
    enabled = spans._enabled
    events = (spans.Recorder.__dict__["_event"], spans.Recorder._resolve)

    def host_event(stream):
        return time.perf_counter_ns()

    def host_resolve(self, rec):
        rec.device_ms = (rec.clock[1] - rec.clock[0]) * 1e-6
        rec.clock = None

    n = 200
    for name, (call, xs) in entries.items():
        for x in xs:
            call(x)
        torch.cuda.synchronize()
        res = {}
        for mode in ("off", "on", "hostclock"):
            spans._enabled = enabled if mode != "off" else (lambda: False)
            if mode == "hostclock":
                spans.Recorder._event = staticmethod(host_event)
                spans.Recorder._resolve = host_resolve
            c0 = sum(getattr(f, a) for f, a in counters)
            with profile(activities=activities) as prof:
                for i in range(n):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    with record_function("bench.call"):
                        r = call(xs[i % len(xs)])
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                del r
                torch.cuda.synchronize()
            c1 = sum(getattr(f, a) for f, a in counters)
            host = []
            for i in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = call(xs[i % len(xs)])
                host.append((time.perf_counter() - t) * 1e3)
                del r
            torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "t.json")
                prof.export_chrome_trace(path)
                busy, window, inside, nlaunch, ndev = _read_trace(path)
            summary = spans.summary()
            spans.clear()
            spans.Recorder._event, spans.Recorder._resolve = events
            spans._enabled = enabled
            res[mode] = {
                "busy_ms_per_call": busy * 1e-3 / n,
                "window_ms_per_call": window * 1e-3 / n,
                "idle_pct": 100.0 * (1.0 - busy / window),
                "host_ms_per_drained_call": sorted(host)[len(host) // 2],
                "wrapper_launches": c1 - c0, "launch_calls": nlaunch, "device_ops": ndev,
                "launches_inside": inside,
                "spans": {k: {"count": s["count"], "self_ms": s["self_ms"] / s["count"],
                              "device_ms": s["device_ms"] / s["count"],
                              "host_ms": s["host_ms"] / s["count"]}
                          for k, s in summary.items()},
            }
            print(name, mode, {k: v for k, v in res[mode].items() if k != "spans"},
                  flush=True)
        out[name] = res
    path = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "build/span_cost.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
