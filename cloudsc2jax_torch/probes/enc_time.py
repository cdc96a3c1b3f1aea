"""Time the encoded TL and AD kernels beside the exact ones in one call, and
hold the encoded kernels against their plain versions and against the exact
kernel run on the decoded trajectory.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/enc_time.py

Prints the relative errors at 100 and 5,001 columns (default encoding and
one with ``pt`` and ``pmfu`` kept f32 too), then ms per launch at 327,680
f32 columns by CUDA events: the exact TL and AD kernels, the encoded ones,
and the two-kernel, encoded and fused units through their wrappers.  Used
to compare variants of ``csrc/cloudsc2_load.cuh``: edit the header, run,
read the encoded rows against the exact ones of the same call.
"""
import sys


def main() -> None:
    sys.path.insert(0, ".")
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.state import Cloudsc2State

    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params

    def rel(got, ref):
        return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(got, ref))

    for ncol in (100, 5001):
        i = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
        for keep in (("pq", "plu", "paph"), ("pq", "plu", "paph", "pt", "pmfu")):
            e = ex.encode_blocked_inputs(i, p, fuse_satur=False, keep_f32=keep)
            o, do, ck = ex.cloudsc2_tl_encoded(e, p, dscale=DSCALE)
            ro, rdo, rck = ex.cloudsc2_tl_encoded_reference(e, p, dscale=DSCALE)
            a = ex.cloudsc2_ad_encoded(e, rdo, rck, p)
            ra = ex.cloudsc2_ad_encoded_reference(e, rdo, rck, p)
            xo, xdo, xck = tk.launch_cloudsc2_tl(ex.decode_inputs(e), ex._prelude(e, p),
                                                 p, dscale=DSCALE)
            print(f"ncol={ncol} keep_f32={keep}: TL vs plain {rel(do, rdo):.3e} "
                  f"{rel(ck, rck):.3e} {rel(o, ro):.3e}, AD vs plain {rel(a, ra):.3e}, "
                  f"TL vs exact kernel on decoded {rel((*do, *ck), (*xdo, *xck)):.3e}",
                  flush=True)

    def time_ms(fn, calls=10):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        t = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        t.record()
        torch.cuda.synchronize()
        return s.elapsed_time(t) / calls

    i = st.device_kernel_inputs(327680, dtype=torch.float32, device="cuda", pqs=True)
    e = ex.encode_blocked_inputs(i, p, fuse_satur=False)
    pre = tk.kernel_prelude(i, p)
    _, do, ck = ex.cloudsc2_tl_encoded(e, p, dscale=DSCALE)

    def enc_unit():
        _, d, c = ex.cloudsc2_tl_encoded(e, p, dscale=DSCALE)
        return ex.cloudsc2_ad_encoded(e, d, c, p)

    for label, fn in (
            ("tl", lambda: tk.launch_cloudsc2_tl(i, pre, p, dscale=DSCALE)),
            ("ad", lambda: tk.launch_cloudsc2_ad(i, pre, do, ck, p)),
            ("tl_enc", lambda: ex.launch_cloudsc2_tl_encoded(e, p, dscale=DSCALE)),
            ("ad_enc", lambda: ex.launch_cloudsc2_ad_encoded(e, do, ck, p)),
            ("unit two", lambda: run_tlad(i, p)),
            ("unit enc", enc_unit),
            ("unit fused", lambda: ex.cloudsc2_tlad_fused(i, p))):
        print(f"{label}: {time_ms(fn):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
