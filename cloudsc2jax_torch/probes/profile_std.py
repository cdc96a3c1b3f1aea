"""Device-time breakdown of the standard-contract TL+AD unit and the host
cost of the truth path.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/profile_std.py

Profiles ``run_tlad(backend="kernels")`` at 327,680 f32 columns with
``torch.profiler`` over 6 calls, on transposed views of levels-major inputs
and on ``(ncol, nlev)``-contiguous inputs, and prints device time by
kernel (rows of aten operators repeat their kernels' time: read the kernel
rows), the host's enqueue time, and the wall time and device-busy time of
the truth path's NL, ``jvp``, Taylor test and adjoint test at 16,384 f64
columns.
"""
import pathlib
import subprocess
import sys
import time


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import profile, ProfilerActivity
    from cloudsc2jax_torch.drivers import run_tlad, taylor_test, adjoint_test
    from cloudsc2jax_torch.state import Cloudsc2State
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs, cloudsc2
    from cloudsc2jax_torch.tlad import cloudsc2_tl
    st = Cloudsc2State.load("tests/fixtures/input.npz"); p = st.params
    ncol = 327680
    lm = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
    for label, mk in (("views", lambda s: Cloudsc2Inputs(*(x.roll(s, dims=1).T for x in lm))),
                      ("contiguous", lambda s: Cloudsc2Inputs(*(x.roll(s, dims=1).T.contiguous() for x in lm)))):
        sets = [mk(s) for s in (0, 37)]
        for s in sets: run_tlad(s, p, backend="kernels")
        torch.cuda.synchronize()
        n = 6
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n): run_tlad(sets[i % 2], p, backend="kernels")
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        rows = [(e.key, e.device_time_total / n / 1e3, e.count / n) for e in prof.key_averages() if e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        tot = sum(r[1] for r in rows)
        print(f"== run_tlad kernels, {label}: wall {wall:.3f} ms/call, device kernels {tot:.3f} ms/call")
        for k, ms, c in rows[:22]:
            print(f"   {ms:8.3f} ms  x{c:5.1f}  {k[:90]}")
        # host enqueue time
        torch.cuda.synchronize(); t0 = time.perf_counter(); run_tlad(sets[0], p, backend="kernels"); t1 = time.perf_counter(); torch.cuda.synchronize(); t2 = time.perf_counter()
        print(f"   host enqueue {(t1-t0)*1e3:.3f} ms, to sync {(t2-t0)*1e3:.3f} ms")
        del sets
    del lm
    torch.cuda.empty_cache()
    # truth path: host-bound?
    for ncol in (16384,):
        i64 = st.device_inputs(ncol, dtype=torch.float64, device="cuda")
        for name, fn in (("cloudsc2 NL", lambda: cloudsc2(i64, p)),
                         ("jvp TL", lambda: cloudsc2_tl(i64, Cloudsc2Inputs(*(0.01 * x for x in i64)), p)),
                         ("taylor_test", lambda: taylor_test(i64, p, nproma=128)),
                         ("adjoint_test", lambda: adjoint_test(i64, p))):
            fn(); torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter(); s.record(); fn(); e.record(); torch.cuda.synchronize(); t1 = time.perf_counter()
            print(f"truth path {name} at {ncol} f64: wall {t1-t0:.3f} s, stream span {s.elapsed_time(e)/1e3:.3f} s")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cloudsc2(i64, p); torch.cuda.synchronize()
        ka = prof.key_averages()
        dev = sum(e.device_time_total for e in ka) / 1e6
        nk = sum(e.count for e in ka if e.device_time_total > 0)
        print(f"truth path NL at {ncol} f64: device busy {dev:.4f} s over {nk} device kernels")
        print(f"peak memory {torch.cuda.max_memory_allocated()/1e9:.2f} GB")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
