"""The kernels against their plain versions with pqs moved away from SATUR.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/perturbed_pqs.py

Builds the four libraries and prints ptxas' report, then, at 100 and 5,000
columns, f32 and f64, ldrain1d off and on, with pqs scaled by seeded
factors within 1% of 1, prints the max relative error per check of the
forward-checkpoint kernel, the two TL kernels and the AD kernel (unfolded
seeds) against their plain versions, for ``lregcl`` off and on.  In f64
the distances stay at rounding level; in f32 they grow with the
conditioning of the perturbed trajectory, which is why ``chip_smoke.py``
perturbs pqs in its f64 cases only.
"""
import pathlib
import sys
import time


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod, tlad_kernel as tk
    from cloudsc2jax_torch.state import Cloudsc2State
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    LIBS = ["cloudsc2_nl", "cloudsc2_tl", "cloudsc2_tl_din", "cloudsc2_ad"]
    t0 = time.perf_counter()
    build.load_libraries(LIBS)
    print(f"build {time.perf_counter()-t0:.1f} s", flush=True)
    for lib in LIBS:
        for e in build.ptxas_report(lib):
            print(lib, e)
    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    def rel(got, ref):
        return max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(got, ref))
    for ncol in (100, 5000):
      for dt in (torch.float32, torch.float64):
        for ld in (False, True):
            i = st.device_kernel_inputs(ncol, dtype=dt, device="cuda", pqs=True)
            gen = torch.Generator(device="cuda").manual_seed(1)
            i = i._replace(pqs=i.pqs * (1 + 0.02 * (torch.rand(i.pqs.shape, generator=gen, device="cuda", dtype=dt) - 0.5)))
            out, ck = kmod.cloudsc2_fwd_ckpt(i, p, ldrain1d=ld)
            rout, rck = kmod.cloudsc2_fwd_ckpt_reference(i, p, ldrain1d=ld)
            print(ncol, dt, ld, "fwd", rel(out, rout), rel(ck, rck), flush=True)
            di = Cloudsc2Inputs(*(0.01 * x * (1 + torch.rand(x.shape, generator=gen, device="cuda", dtype=dt)) for x in i))
            for lr in (False, True):
                o, do = tk.cloudsc2_tl_din(i, di, p, lregcl=lr, ldrain1d=ld)
                ro, rdo, rck2 = tk.cloudsc2_tl_reference(i, p, d_inputs=di, lregcl=lr, ldrain1d=ld)
                o2, do2, ck2 = tk.cloudsc2_tl(i, p, dscale=0.01, lregcl=lr, ldrain1d=ld)
                r2 = tk.cloudsc2_tl_reference(i, p, dscale=0.01, lregcl=lr, ldrain1d=ld)
                adj = tk.cloudsc2_ad(i, rdo, rck2, p, lregcl=lr, ldrain1d=ld, fold_seeds=False)
                radj = tk.cloudsc2_ad_reference(i, rdo, rck2, p, lregcl=lr, ldrain1d=ld, fold_seeds=False)
                torch.cuda.synchronize()
                print(ncol, dt, ld, "lregcl", lr, "tl_din", rel(o, ro), rel(do, rdo), "tl", rel(do2, r2[1]), rel(ck2, r2[2]), "ad", rel(adj, radj), flush=True)
    print("launches", kmod.cloudsc2_fwd_ckpt.launches, tk.cloudsc2_tl_din.launches, tk.cloudsc2_tl.launches, tk.cloudsc2_ad.launches)


if __name__ == "__main__":
    main()
