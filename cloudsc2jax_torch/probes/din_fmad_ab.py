"""The streamed-increment TL kernel with and without FMA contraction, as
medians over processes.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/din_fmad_ab.py [processes]

``cloudsc2_tl_din`` ships built with ``-fmad=false``; ``contracted`` builds
it with nvcc's default (``-fmad=true``, the build before it shipped so) and
``shipped`` as it ships.  Both libraries are built first, then each
process times one build in turns (contracted, shipped, shipped, contracted,
...), ``processes`` of each (default 3): at 327,680 f32 columns with CUDA
events over three input sets, the kernel alone (20 launches) and the
standard-contract unit ``run_tlad(backend="kernels")`` on transposed views
of levels-major inputs (10 calls); and, at 16,384 columns, ``cli.tl_parity``
with ``lregcl`` off and on.  Each process prints one JSON line with its
build's SASS digest; the last line holds the medians over processes and the
card's name and power limit.
"""
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BUILDS = {"contracted": ("-fmad=true",), "shipped": ("-fmad=false",)}
NCOL = 327_680
PARITY_NCOL = 16_384


def _time_ms(fn, args_list, calls: int) -> float:
    import torch

    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def child(tag: str) -> dict:
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_kernel_tl,
        launch_cloudsc2_tl_din,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    build.VARIANTS["cloudsc2_tl_din"] = ((), BUILDS[tag])
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    base = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, p) for s in sets]
    dsets = [Cloudsc2Inputs(*(DSCALE * x for x in s)) for s in sets]
    views = [Cloudsc2Inputs(*(x.T for x in s)) for s in sets]
    res = {"build": tag, "flags": list(BUILDS[tag]),
           "din_ms": _time_ms(lambda i, d, q: launch_cloudsc2_tl_din(i, d, q, p),
                              list(zip(sets, dsets, pres)), 20),
           "run_tlad_kernels_views_ms": _time_ms(
               lambda v: run_tlad(v, p, backend="kernels"), [(v,) for v in views], 10)}
    del sets, pres, dsets, views, base
    i32 = st.device_inputs(PARITY_NCOL, dtype=torch.float32, device="cuda")
    d32 = Cloudsc2Inputs(*(DSCALE * x for x in i32))
    for lregcl in (False, True):
        _, dk = cloudsc2_kernel_tl(i32, d32, p, lregcl=lregcl)
        res[f"tl_parity_lregcl_{lregcl}"] = cli.tl_parity(i32, dk, p, lregcl=lregcl)
    res["sass"] = build.library_digest(build.sass_digests(build.sass("cloudsc2_tl_din")))
    return res


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    processes = int(argv[0]) if argv else 3
    from cloudsc2jax_torch.kernels import build

    build.load_libraries([("cloudsc2_tl_din", (), f) for f in BUILDS.values()]
                         + ["cloudsc2_nl", "cloudsc2_ad"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    order = []
    for n in range(processes):
        pair = ["contracted", "shipped"]
        order += pair if n % 2 == 0 else pair[::-1]
    readings = {tag: [] for tag in BUILDS}
    for tag in order:
        proc = subprocess.run([sys.executable, __file__, "--child", tag],
                              capture_output=True, text=True, cwd=ROOT, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        readings[tag].append(rec)
        print(json.dumps(rec), flush=True)
    keys = ("din_ms", "run_tlad_kernels_views_ms")
    print(json.dumps({"card": card, "processes": processes, "order": order,
                      "median": {tag: {k: statistics.median(r[k] for r in rs)
                                       for k in keys}
                                 for tag, rs in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
