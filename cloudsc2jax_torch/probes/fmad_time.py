"""Kernel times with and without FMA contraction.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/fmad_time.py [nofmad]

Times the five kernels with CUDA events over distinct inputs at 327,680
f32 and 163,840 f64 columns and prints ptxas' registers and spills.
``nofmad`` builds with ``-fmad=false``.  To compare, run the two builds in
turns in one session on one card (fmad, nofmad, nofmad, fmad).
"""
import pathlib
import subprocess
import sys


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch
    from cloudsc2jax_torch.kernels import build
    tag = "fmad"
    if len(sys.argv) > 1 and sys.argv[1] == "nofmad":
        build.VARIANTS["cloudsc2_nl"] = ((), ("-fmad=false",))
        build.VARIANTS["cloudsc2_tl"] = ((), ("-fmad=false",))
        build.VARIANTS["cloudsc2_tl_din"] = ((), ("-fmad=false",))
        build.VARIANTS["cloudsc2_ad"] = ((), ("-fmad=false",))
        tag = "nofmad"
    from cloudsc2jax_torch.kernels import tlad_kernel as tk, cloudsc2_kernel as km
    from cloudsc2jax_torch.state import Cloudsc2State
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    st = Cloudsc2State.load("tests/fixtures/input.npz"); p = st.params
    def time_ms(fn, args_list, calls):
        for a in args_list: fn(*a)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(calls): fn(*args_list[i % len(args_list)])
        e.record(); torch.cuda.synchronize()
        return s.elapsed_time(e) / calls
    res = {}
    for dt, ncol in ((torch.float32, 327680), (torch.float64, 163840)):
        base = st.device_kernel_inputs(ncol, dtype=dt, device="cuda", pqs=True)
        sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
        pres = [km.kernel_prelude(s, p) for s in sets]
        dsets = [Cloudsc2Inputs(*(0.01 * x for x in s)) for s in sets]
        tls = [tk.launch_cloudsc2_tl(i, q, p, dscale=0.01) for i, q in zip(sets, pres)]
        r = {
          "nl": time_ms(lambda i, q: km.launch_cloudsc2_nl(i, q, p), list(zip(sets, pres)), 20),
          "fwd": time_ms(lambda i, q: km.launch_cloudsc2_fwd_ckpt(i, q, p), list(zip(sets, pres)), 20),
          "tl": time_ms(lambda i, q: tk.launch_cloudsc2_tl(i, q, p, dscale=0.01), list(zip(sets, pres)), 20),
          "tl_lregcl_off": time_ms(lambda i, q: tk.launch_cloudsc2_tl(i, q, p, dscale=0.01, lregcl=False), list(zip(sets, pres)), 20),
          "din": time_ms(lambda i, d, q: tk.launch_cloudsc2_tl_din(i, d, q, p), list(zip(sets, dsets, pres)), 20),
          "ad": time_ms(lambda i, q, t: tk.launch_cloudsc2_ad(i, q, t[1], t[2], p), list(zip(sets, pres, tls)), 20),
        }
        res[str(dt)] = r
        print(tag, dt, ncol, {k: round(v, 4) for k, v in r.items()}, flush=True)
        del base, sets, pres, dsets, tls
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for lib in ("cloudsc2_tl", "cloudsc2_tl_din", "cloudsc2_ad", "cloudsc2_nl"):
        for e in build.ptxas_report(lib):
            if "If" in e["entry"] or "cloudsc2_nl" == lib:
                print(tag, lib, e["entry"][-60:], e["registers"], e["spill_store_bytes"])


if __name__ == "__main__":
    main()
