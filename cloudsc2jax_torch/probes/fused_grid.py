"""Time the fused TL+AD kernel under several splits of its block into TL and
AD warpgroups, to choose the split by measurement.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/fused_grid.py [NT+NA:blocks:tl:ad:depth ...]

Each argument is one split of the f32 work unit's body (evaporation off,
``lregcl`` on): TL and AD warpgroups per block, blocks per SM, the TL and AD
roles' register budgets (``setmaxnreg``) and the ring depth; the default is
a spread around the shipped split.  A split that breaks a rule of
``kernels/fused_plan.py`` prints its reason and is skipped.  The probe
builds ``csrc/cloudsc2_tlad_fused.cu`` once per split, with that variant's
define replaced (``build.variant``; the only place the splits are set
other than the shipped table), all nvcc runs started together; then per
split it holds one launch against the two-kernel unit at 327,680 f32
columns (max relative error), and times the kernel twice by CUDA events
over 9 launches on three input sets.  One JSON line per split: the split,
launch registers and ptxas' count, each role's registers and
local-memory spills read from SASS, warps per SM per role, shared bytes
per block, the checkpoint ring's bytes, the error and both times, with
the card's name and power limit.
"""
import json
import subprocess
import sys


def parse(text: str):
    """``NT+NA:blocks:tl:ad:depth`` as a fused_plan.Split."""
    from cloudsc2jax_torch.kernels.fused_plan import Split

    groups, blocks, tl, ad, depth = text.split(":")
    nt, na = groups.split("+")
    return Split(int(nt), int(na), int(blocks), int(tl), int(ad), int(depth))


DEFAULT = ("1+1:3:64:96:2", "1+1:3:64:96:1", "1+1:3:64:96:4", "1+1:2:64:192:2",
           "1+1:4:56:72:2", "1+2:2:64:88:2", "1+2:2:72:80:2", "1+3:1:64:144:3",
           "1+4:1:64:104:4", "2+2:1:64:192:2", "2+4:1:64:88:2", "3+3:1:64:96:2")


def main(argv) -> int:
    sys.path.insert(0, ".")
    import torch

    from cloudsc2jax_torch.drivers import run_tlad
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import fused_plan as fp
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("fused_grid: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    variant = ("float32", False, True)
    builds = []
    for text in argv or DEFAULT:
        split = parse(text)
        try:
            fp.check(split, variant)
        except ValueError as err:
            print(json.dumps({"split": text, "refused": str(err)}), flush=True)
            continue
        builds.append((text, split, fp.defines({**fp.PLANS, variant: split})))
    build.load_libraries([("cloudsc2_tlad_fused", d) for _, _, d in builds])

    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    ncol = 327_680
    base = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
    pres = [kernel_prelude(s, p) for s in sets]
    unit = run_tlad(base, p)

    def time_ms(calls=9):
        for i, pre in zip(sets, pres):
            ex.launch_cloudsc2_tlad_fused(i, pre, p)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in range(calls):
            ex.launch_cloudsc2_tlad_fused(sets[c % 3], pres[c % 3], p)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / calls

    rows = []
    for text, split, defines in builds:
        with build.variant("cloudsc2_tlad_fused", defines):
            plan = ex.fused_launch_plan(base, p)
            got = ex.launch_cloudsc2_tlad_fused(base, pres[0], p)
            err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                      for g, u in zip(got, unit) for a, b in zip(g, u))
            del got
            ms = [time_ms(), time_ms()]
        roles = build.role_registers("cloudsc2_tlad_fused",
                                     ["cloudsc2_tlad_fused_kernel", "IfLb0ELb1E"],
                                     defines)
        row = {"split": text, "launch_registers": split.launch_registers,
               "kernel_registers": plan["kernel_registers"], "roles": roles,
               "warps_per_sm": split.warps_per_sm(),
               "shared_bytes": plan["shared_bytes"],
               "scratch_mb": plan["scratch_bytes"] / 1e6, "blocks": plan["blocks"],
               "max_rel_err_vs_two": err, "ms": ms, "ncol": ncol, "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "fused_grid": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
