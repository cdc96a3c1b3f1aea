"""Where the f32 TL parity budget goes, with and without FMA contraction
in the kernels.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/parity.py [nofmad]

At 100 and 16,384 columns and with ``lregcl`` off and on, prints the max
relative error per field of the TL tangents between the streamed-increment
TL kernel, its plain version and ``jvp`` of the truth path, in f32 and
against the truth path in f64.  ``nofmad`` builds the kernels with
``-fmad=false`` (into a build directory of its own) before measuring.
"""
import pathlib
import sys
import time


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import subprocess

    import torch
    from cloudsc2jax_torch.kernels import build
    tag = "fmad"
    if len(sys.argv) > 1 and sys.argv[1] == "nofmad":
        build.VARIANTS["cloudsc2_tl_din"] = ((), ("-fmad=false",))
        tag = "nofmad"
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.state import Cloudsc2State
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.tlad import cloudsc2_tl as truth_tl

    st = Cloudsc2State.load("tests/fixtures/input.npz"); p = st.params
    def rels(got, ref):
        out = {}
        for n, g, r in zip(ref._fields, got, ref):
            out[n] = ((g.double() - r.double()).abs().max() / r.double().abs().max().clamp_min(1e-300)).item()
        return out
    for ncol in (100, 16384):
        i64 = st.device_inputs(ncol, dtype=torch.float64, device="cuda")
        i32 = Cloudsc2Inputs(*(x.float() for x in i64))
        sc = lambda t: Cloudsc2Inputs(*(0.01 * x for x in t))
        for lregcl in (False, True):
            t0 = time.time()
            _, d64 = truth_tl(i64, sc(i64), p, lregcl=lregcl)
            _, dt32 = truth_tl(i32, sc(i32), p, lregcl=lregcl)
            _, dk32 = tk.cloudsc2_kernel_tl(i32, sc(i32), p, lregcl=lregcl)
            lm = tk.to_levels_major(i32)
            _, dp, _ = tk.cloudsc2_tl_reference(lm, p, d_inputs=sc(lm), lregcl=lregcl)
            from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs
            dp32 = unblock_outputs(dp, p)
            _, dk64 = tk.cloudsc2_kernel_tl(i64, sc(i64), p, lregcl=lregcl)
            for label, got, ref in (("kernel32_vs_truth64", dk32, d64), ("truth32_vs_truth64", dt32, d64),
                                    ("plain32_vs_truth64", dp32, d64),
                                    ("kernel32_vs_truth32", dk32, dt32), ("kernel32_vs_plain32", dk32, dp32),
                                    ("plain32_vs_truth32", dp32, dt32), ("kernel64_vs_truth64", dk64, d64)):
                r = rels(got, ref)
                worst = max(r, key=r.get)
                print(tag, ncol, "lregcl", lregcl, label, f"{r[worst]:.3e}", worst, {k: f"{v:.2e}" for k, v in r.items()}, flush=True)
            print("  took", time.time() - t0, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
