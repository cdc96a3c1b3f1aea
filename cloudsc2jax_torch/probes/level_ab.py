"""The TL or AD kernel of this checkout against another's, in turns in one
process, on one CUDA card.

Run from the root of a checkout, on a machine with one card, with another
checkout unpacked by ``git archive`` into a gitignored directory::

    python3 cloudsc2jax_torch/probes/level_ab.py <tl|ad> <root of the other checkout> [turns]

Both run the stream contract's sweep of ``kind`` (``tlad_kernel.
launch_cloudsc2_tl`` without the primal, or ``launch_cloudsc2_ad``) on the
same inputs, at 327,680 columns of the fixture's 137 levels, f32 and f64
with evaporation off and f32 with LEVAPLS2 on (``lregcl`` on), the AD from
the same seeds (this checkout's TL); the TL also the standard contract's
build (``launch_cloudsc2_tl_std``: ``build.NO_FMA``, the primal written),
f32.  Prints JSON lines, each with the card's name and power limit:

* ``sass``: per library that ``chip_smoke.py`` phase 2 builds, the digest
  of its SASS (``build.library_digest``) in both checkouts, and whether
  they are equal;
* ``loop``: per checkout and case, registers and spills (ptxas) of the
  kernel entry, the blocks an SM holds (``build.occupancy``), and its level
  loop's census (``build.loop_census``: the count of instructions, of each
  opcode and of each ``MUFU`` function);
* ``check``: per case, this checkout's outputs against the other's: the
  share of elements equal bit for bit, and per stream the largest
  difference over the stream's largest magnitude;
* ``time``: ms per launch by CUDA events (10 launches cycling two input
  sets), in turns other, this, this, other, ``turns`` times (default 2).
"""
import dataclasses
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
# per kind, the cases: (name, dtype, LEVAPLS2, standard build); the TL's
# entries are cloudsc2_tl_kernel<T, EVAP, LREGCL, WRITE_PRIMAL>, the AD's
# cloudsc2_ad_kernel<T, EVAP, LREGCL>
CASES = {
    "tl": (("f32", "f", False, False), ("f64", "d", False, False),
           ("f32_evap", "f", True, False), ("f32_std", "f", False, True)),
    "ad": (("f32", "f", False, False), ("f64", "d", False, False),
           ("f32_evap", "f", True, False)),
}


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.probes.enc_ab import card, load_other
    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("level_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) < 2 or argv[0] not in CASES:
        print(__doc__, file=sys.stderr)
        return 2
    kind = argv[0]
    other = load_other(pathlib.Path(argv[1]).resolve())
    turns = int(argv[2]) if len(argv) > 2 else 2
    obuild = importlib.import_module(other.__name__ + ".kernels.build")
    otk = importlib.import_module(other.__name__ + ".kernels.tlad_kernel")
    name = card()

    def emit(what, **record):
        print(json.dumps({"record": what, "card": name, **record}), flush=True)

    specs = [(lib, (), ()) for lib in chip_smoke.LIBRARIES if lib != "bw_probe"]
    specs.append(chip_smoke.STD_TL)
    build.load_libraries(specs)
    obuild.load_libraries(specs)
    for lib, defines, flags in specs:
        mine = build.library_digest(build.sass_digests(build.sass(lib, defines, flags)))
        theirs = obuild.library_digest(obuild.sass_digests(obuild.sass(lib, defines, flags)))
        emit("sass", library=" ".join((lib, *flags)), equal=mine == theirs,
             this=mine, other=theirs)

    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    lib = f"cloudsc2_{kind}"
    for case, code, evap, std in CASES[kind]:
        dtype = torch.float32 if code == "f" else torch.float64
        p = st.params
        if evap:
            p = p.replace(yophnc=dataclasses.replace(p.yophnc, levapls2=True))
        flags = build.NO_FMA if std else ()
        switches = (int(evap), 1) + ((int(std),) if kind == "tl" else ())
        mark = f"{lib}_kernelI{code}Lb{int(evap)}ELb1E" + ("Lb1E" if std else
                                                          "Lb0E" if kind == "tl" else "")
        like = torch.empty(1, dtype=dtype, device="cuda")
        for label, b, m in (("other", obuild, otk), ("this", build, tk)):
            (e,) = [e for e in b.ptxas_report(lib, (), flags) if mark in e["entry"]]
            c = build.loop_census(b.sass(lib, (), flags), [e["entry"]], detail=("MUFU",))
            occ = b.occupancy(m._library(lib, flags) if flags else m._library(lib),
                              lib, like, *switches)
            emit("loop", kind=kind, case=case, build=label, registers=e.get("registers"),
                 stack_bytes=e.get("stack_bytes"),
                 spill_store_bytes=e.get("spill_store_bytes"),
                 spill_load_bytes=e.get("spill_load_bytes"),
                 blocks_per_sm=occ.get("blocks_per_sm"),
                 loop_instructions=c["instructions"], loop_ops=c["ops"],
                 loop_mufu=c["detail"])

        base = st.device_kernel_inputs(NCOL, dtype=dtype, device="cuda", pqs=True)
        sets = [base, Cloudsc2Inputs(*(x.roll(37, dims=1) for x in base))]
        pres = [kernel_prelude(s, p) for s in sets]
        seeds = ([tk.launch_cloudsc2_tl(s, q, p, dscale=DSCALE, write_primal=False)
                  for s, q in zip(sets, pres)] if kind == "ad" else None)

        def run(module, i):
            if kind == "ad":
                return tuple(module.launch_cloudsc2_ad(sets[i], pres[i], seeds[i][1],
                                                       seeds[i][2], p))
            if std:
                out, dout, ck = module.launch_cloudsc2_tl_std(sets[i], pres[i], p,
                                                              dscale=DSCALE)
                return (*out, *dout, *ck)
            _, dout, ck = module.launch_cloudsc2_tl(sets[i], pres[i], p, dscale=DSCALE,
                                                    write_primal=False)
            return (*dout, *ck)

        got, want = run(tk, 0), run(otk, 0)
        equal = sum(int((a == b).sum()) for a, b in zip(got, want))
        total = sum(b.numel() for b in want)
        gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
                for a, b in zip(got, want)]
        emit("check", kind=kind, case=case, ncol=NCOL, equal_share=equal / total,
             worst=max(gaps), gaps=gaps)
        del got, want

        def time_ms(module, calls=10):
            for i in range(len(sets)):
                run(module, i)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for c in range(calls):
                run(module, c % len(sets))
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / calls

        for turn in range(turns):
            for label, module in (("other", otk), ("this", tk), ("this", tk),
                                  ("other", otk)):
                emit("time", kind=kind, case=case, ncol=NCOL, turn=turn, build=label,
                     ms=time_ms(module))
        del sets, pres, seeds
        torch.cuda.empty_cache()
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
