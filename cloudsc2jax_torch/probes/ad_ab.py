"""The reverse-adjoint kernel of this checkout against another's, in turns
in one process, on one CUDA card.

Run from the root of a checkout, on a machine with one card, with another
checkout unpacked by ``git archive`` into a gitignored directory::

    python3 cloudsc2jax_torch/probes/ad_ab.py <root of the other checkout> [turns]

Both run the stream contract's AD (``tlad_kernel.launch_cloudsc2_ad``,
evaporation off, ``lregcl`` on) on the same inputs, at 327,680 columns of
the fixture's 137 levels, f32 and f64, from the same seeds (this checkout's
TL).  Prints JSON lines, each with the card's name and power limit:

* ``sass``: per library that ``chip_smoke.py`` phase 2 builds, the digest
  of its SASS (``build.library_digest``) in both checkouts, and whether
  they are equal;
* ``loop``: per checkout and precision, registers and spills (ptxas) of the
  AD entry, and its level loop's census (``build.loop_census``: the count
  of instructions, of each opcode and of each ``MUFU`` function);
* ``check``: per precision, this checkout's adjoints against the other's:
  the share of elements equal bit for bit, and per field the largest
  difference over the field's largest magnitude;
* ``time``: ms per launch by CUDA events (10 launches cycling two input
  sets), in turns other, this, this, other, ``turns`` times (default 2).
"""
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
MARKS = {"f32": ("cloudsc2_ad_kernel", "IfLb0ELb1E"),
         "f64": ("cloudsc2_ad_kernel", "IdLb0ELb1E")}


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
        print("ad_ab: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(pathlib.Path(argv[0]).resolve())
    turns = int(argv[1]) if len(argv) > 1 else 2
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

    for label, b in (("other", obuild), ("this", build)):
        text = b.sass("cloudsc2_ad")
        for prec, marks in MARKS.items():
            (e,) = [e for e in b.ptxas_report("cloudsc2_ad")
                    if all(m in e["entry"] for m in marks)]
            c = build.loop_census(text, [e["entry"]], detail=("MUFU",))
            emit("loop", build=label, dtype=prec, registers=e.get("registers"),
                 stack_bytes=e.get("stack_bytes"),
                 spill_store_bytes=e.get("spill_store_bytes"),
                 loop_instructions=c["instructions"], loop_ops=c["ops"],
                 loop_mufu=c["detail"])

    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        base = st.device_kernel_inputs(NCOL, dtype=dtype, device="cuda", pqs=True)
        sets = [base, Cloudsc2Inputs(*(x.roll(37, dims=1) for x in base))]
        pres = [kernel_prelude(s, p) for s in sets]
        seeds = [tk.launch_cloudsc2_tl(s, q, p, dscale=DSCALE, write_primal=False)
                 for s, q in zip(sets, pres)]

        def ad(module, i):
            return module.launch_cloudsc2_ad(sets[i], pres[i], seeds[i][1],
                                             seeds[i][2], p)

        got, want = ad(tk, 0), ad(otk, 0)
        equal = sum(int((a == b).sum()) for a, b in zip(got, want))
        total = sum(b.numel() for b in want)
        gaps = {f: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
                for f, a, b in zip(Cloudsc2Inputs._fields, got, want)}
        emit("check", dtype=prec, ncol=NCOL, equal_share=equal / total,
             worst=max(gaps.values()), gaps=gaps)
        del got, want

        def time_ms(module, calls=10):
            for i in range(len(sets)):
                ad(module, i)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for c in range(calls):
                ad(module, c % len(sets))
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / calls

        for turn in range(turns):
            for label, module in (("other", otk), ("this", tk), ("this", tk),
                                  ("other", otk)):
                emit("time", dtype=prec, ncol=NCOL, turn=turn, build=label,
                     ms=time_ms(module))
        del sets, pres, seeds
        torch.cuda.empty_cache()
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
