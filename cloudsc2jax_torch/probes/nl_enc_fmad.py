"""Where the encoded NL kernel's distance to its plain version comes from:
FMA contraction, or a value that the 48-register build spilled.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/nl_enc_fmad.py

Two builds of ``csrc/cloudsc2_nl_enc.cu`` and ``csrc/cloudsc2_nl.cu`` in one
process, nvcc's default (multiply-adds contracted) and ``-fmad=false``.  For
each, every combination of ``fuse_satur``, ``keep_f32`` and payload at 100
columns (ldrain1d off and on) and at an odd 5,001 (ldrain1d on): the worst
output field of max |kernel - plain| / max |plain| with the plain version on
the decoded trajectory, and beside it the same distance for the EXACT kernel
of ``cloudsc2_nl.cu`` (48 or 94 registers, no spills) launched on the same
decoded inputs with the encoding's own tropopause eta and surface pressure.
If the two kernels sit equally far from the plain version and both fall to
rounding level without contraction, the distance is the contraction's and
not a spill's.  One JSON line per case and build (with the number of elements
of the worst field that sit more than 1e-6 of its max from the plain version,
and where the worst one is), then the worst of each build and, for that case,
how far the kernel and the plain version, both f32, sit from the plain
version in f64 on the same decoded trajectory; ptxas' registers and spills,
and the card.
"""
import json
import pathlib
import subprocess
import sys


def main() -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch

    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    keeps = {"default": ("pq", "plu", "paph"), "pq": ("pq",),
             "all": ex.ENCODED_STREAMS, "none": ()}
    combos = [(fs, keep, payload) for fs in (True, False) for keep in keeps
              for payload in (torch.int16, torch.bfloat16)]

    def worst_field(got, ref):
        rel = {n: ((a.double() - b.double()).abs().max()
                   / b.double().abs().max().clamp_min(1e-30)).item()
               for n, a, b in zip(km.KERNEL_OUTPUTS, got, ref)}
        name = max(rel, key=rel.get)
        return name, rel[name]

    def outliers(got, ref, name):
        """Elements of field ``name`` more than 1e-6 of its max away, and the
        (level, column) of the worst."""
        j = km.KERNEL_OUTPUTS.index(name)
        d = (got[j] - ref[j]).abs()
        where = divmod(int(d.argmax()), d.shape[1])
        return int((d > 1e-6 * ref[j].abs().max()).sum()), where

    def plain_f64(enc, ldrain1d):
        """The plain sweep in f64 on the decoded f32 trajectory."""
        decoded = Cloudsc2Inputs(*(None if x is None else x.double()
                                   for x in ex.decode_inputs(enc)))
        ztrpaus = enc.ztrpaus.double()
        ceta, zscalm = km.level_scalars(p, ztrpaus)
        pre = km.KernelPrelude(ceta=ceta, zscalm=zscalm, ztrpaus=ztrpaus,
                               paph_sfc=enc.paphsfc.double())
        return km._nl_sweep(decoded, p, ldrain1d, pqs_stream=not enc.fuse_satur,
                            checkpoints=False, pre=pre)[0]

    flags = build.NVCC_FLAGS
    for tag, extra in (("fmad", ()), ("nofmad", ("-fmad=false",))):
        build.NVCC_FLAGS = flags + extra
        for key in (("cloudsc2_nl_enc", (), ()), ("cloudsc2_nl", (), ())):
            build._LIBRARIES.pop(key, None)
        top = {"enc": ("", 0.0, ""), "exact": ("", 0.0, "")}
        top_case = None
        for ncol, ldrain1d in ((100, False), (100, True), (5001, True)):
            inputs = st.device_kernel_inputs(ncol, dtype=torch.float32,
                                             device="cuda", pqs=True)
            for fuse_satur, keep, payload in combos:
                enc = ex.encode_blocked_inputs(
                    inputs, p, keep_f32=keeps[keep], fuse_satur=fuse_satur,
                    payload_dtype=payload)
                ref = ex.cloudsc2_nl_encoded_reference(enc, p, ldrain1d=ldrain1d)
                got = ex.launch_cloudsc2_nl_encoded(enc, p, ldrain1d=ldrain1d)
                decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, p)
                if fuse_satur:
                    exact = km.launch_cloudsc2_nl(decoded, pre, p, ldrain1d=ldrain1d)
                else:
                    exact = km.launch_cloudsc2_fwd_ckpt(decoded, pre, p,
                                                        ldrain1d=ldrain1d)[0]
                case = (f"ncol={ncol} ldrain1d={ldrain1d} fuse_satur={fuse_satur} "
                        f"keep={keep} {str(payload).split('.')[-1]}")
                row = {"build": tag, "case": case}
                for label, out in (("enc", got), ("exact", exact)):
                    name, rel = worst_field(out, ref)
                    over, where = outliers(out, ref, name)
                    row[label] = {"field": name, "max_rel_err": rel,
                                  "elements_over_1e-6": over, "worst_at": where}
                    if rel > top[label][1]:
                        top[label] = (name, rel, case)
                        if label == "enc":
                            top_case = (enc, ldrain1d, got, ref)
                row["enc_equals_exact_kernel"] = all(
                    torch.equal(a, b) for a, b in zip(got, exact))
                print(json.dumps(row), flush=True)
        print(json.dumps({"build": tag, "worst": {
            k: {"field": f, "max_rel_err": r, "case": c}
            for k, (f, r, c) in top.items()}}), flush=True)
        enc, ldrain1d, got, ref = top_case
        truth = plain_f64(enc, ldrain1d)
        print(json.dumps({"build": tag, "worst_case_against_plain_f64": {
            label: dict(zip(("field", "max_rel_err"), worst_field(out, truth)))
            for label, out in (("kernel_f32", got), ("plain_f32", ref))}}),
            flush=True)
        for lib, mark in (("cloudsc2_nl_enc", "ILb"), ("cloudsc2_nl", "If")):
            for e in build.ptxas_report(lib):
                if mark in e["entry"]:
                    print(tag, lib, e["entry"][-48:], e["registers"], "registers,",
                          e["spill_store_bytes"], "B spill stores", flush=True)
    build.NVCC_FLAGS = flags
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
