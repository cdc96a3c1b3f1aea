"""The encoded NL kernel of this checkout against another checkout's, in
turns, as medians over processes, on one CUDA card; and its register budget
swept through its define.

Run from the root of a checkout that holds ``tests/fixtures``, on a machine
with one card, with another checkout unpacked by ``git archive`` into a
gitignored directory::

    python3 cloudsc2jax_torch/probes/nl_enc_ab.py <root of the other checkout> [processes] [variant ...]

A variant is ``NAME=DEFINE[,DEFINE...]``: this checkout's encoded NL library
built with those ``-D`` defines (``b8=CLOUDSC2_NL_ENC_MIN_BLOCKS_F32=8``);
``sweep`` stands for the budgets 6, 8, 10, 11 and 12 (``b6`` ... ``b12``).
The other checkout's package is loaded beside this one under another name,
with its own build.  ``processes`` (default 3) processes run one after
another; the first also prints:

* ``check``: every build's outputs for every encoding below, and for the
  default and ``("pq",)`` keeps with pqs streamed, against the other
  checkout's and against this checkout's exact NL kernel (pqs computed) or
  forward-checkpoint kernel (pqs streamed) on the decoded inputs, bit for
  bit, at 327,680 columns;
* ``loop``: registers and spills (ptxas) of each build's f32 entries with
  evaporation off and pqs computed (int16 payload, the fixed and the
  runtime kernel; the other checkout's one kernel) and of the exact NL
  kernel, and the count of instructions and of each load and store opcode
  in their level loop (SASS);
* ``sass``: per library of both checkouts but the encoded NL one (the
  window probe at its NL mix), the digest of its SASS, and whether they are
  equal.

Every process prints ``time`` records: ms per launch by CUDA events (30
launches cycling three input sets at 327,680 f32 columns, pqs computed) for
the default encoding, ``keep_f32=("pq",)``, the bfloat16 payload, the
all-f32 control and, for this checkout's builds, the default encoding on
the runtime-mask kernel; in turns: the exact NL kernel, other, this, the
variants, the variants again, this, other, the exact NL kernel.  The last
line is the medians over processes of each process's mean per build and
encoding, with the card's name and power limit.
"""
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
LIBRARY = "cloudsc2_nl_enc"
BUDGET = "CLOUDSC2_NL_ENC_MIN_BLOCKS_F32"
SWEEP = (6, 8, 10, 11, 12)
# the libraries whose code must not change with the encoded NL one's
EXACT_LIBRARIES = ("cloudsc2_nl", "cloudsc2_nl_res", "cloudsc2_tl",
                   "cloudsc2_tl_din", "cloudsc2_ad", "cloudsc2_tlad_fused",
                   "cloudsc2_tl_enc", "cloudsc2_ad_enc", "bw_probe")
# timed encodings: (fuse_satur, keep_f32 label, payload, kernel)
TIMED = {"default": (True, "default", "int16", None),
         "pq": (True, "pq", "int16", None),
         "bf16": (True, "default", "bfloat16", None),
         "all_f32": (True, "all", "int16", None),
         "default_runtime": (True, "default", "int16", "runtime")}
# checked besides the timed ones: pqs streamed
CHECKED = {**TIMED, "streamed_default": (False, "default", "int16", None),
           "streamed_pq": (False, "pq", "int16", None)}
# f32 entries with evaporation off and pqs computed, int16 payload
MARKS = {"fixed": ("cloudsc2_nl_enc_kernel", "ILb0ELb0ELb0ELj8189E"),
         "runtime": ("cloudsc2_nl_enc_kernel", "ILb0ELb0ELb0ELj0E"),
         "other": ("cloudsc2_nl_enc_kernel", "ILb0ELb0ELb0EE"),
         "exact": ("cloudsc2_nl_kernel", "IfLb0E")}
LOADS = ("LDG", "LDC", "ULDC", "LDS", "STS", "STG", "LDL", "STL")


def variants_of(specs):
    """{label: defines} of this checkout's builds, "this" first."""
    out = {"this": ()}
    for spec in specs:
        if spec == "sweep":
            out.update({f"b{b}": (f"{BUDGET}={b}",) for b in SWEEP})
            continue
        label, _, defines = spec.partition("=")
        out[label] = tuple(defines.split(","))
    return out


def run_process(other_root: pathlib.Path, variants: dict, first: bool) -> int:
    sys.path.insert(0, str(ROOT))
    import importlib

    import torch

    from cloudsc2jax_torch.bw_probe import probe_defines
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.probes.enc_ab import card, load_other
    from cloudsc2jax_torch.probes.tlad_budget import time_ms
    from cloudsc2jax_torch.state import Cloudsc2State

    name = card()

    def emit(what, **record):
        print(json.dumps({"record": what, "card": name, **record}), flush=True)

    other = load_other(other_root)
    obuild = importlib.import_module(other.__name__ + ".kernels.build")
    oex = importlib.import_module(other.__name__ + ".kernels.experiments")
    mix = probe_defines(15, 8, (0, 0))
    exact = [(lib, mix if lib == "bw_probe" else ()) for lib in EXACT_LIBRARIES]
    build.load_libraries(exact + [(LIBRARY, d) for d in variants.values()])
    obuild.load_libraries(exact + [LIBRARY])

    if first:
        for lib, defines in exact:
            mine = build.sass_digests(build.sass(lib, defines))
            theirs = build.sass_digests(obuild.sass(lib, defines))
            emit("sass", library=lib, equal=mine == theirs,
                 digest=build.library_digest(mine),
                 other_digest=build.library_digest(theirs),
                 differ=sorted(e for e in mine if mine[e] != theirs.get(e)))
        rows = [("exact", build, "cloudsc2_nl", (), "exact"),
                ("other", obuild, LIBRARY, (), "other")]
        rows += [(v, build, LIBRARY, d, kind) for v, d in variants.items()
                 for kind in ("fixed", "runtime")]
        for label, b, lib, defines, kind in rows:
            text = b.sass(lib, defines)
            for e in b.ptxas_report(lib, defines):
                if not all(m in e["entry"] for m in MARKS[kind]):
                    continue
                c = build.loop_census(text, [e["entry"]])
                emit("loop", build=label, kernel=kind, entry=e["entry"],
                     registers=e.get("registers"),
                     spill_store_bytes=e.get("spill_store_bytes"),
                     spill_load_bytes=e.get("spill_load_bytes"),
                     loop_instructions=c["instructions"],
                     loop_ops={op: c["ops"].get(op, 0) for op in LOADS})

    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    base = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cuda",
                                   pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    keeps = {"default": ex._KEEP_F32, "pq": ("pq",), "all": ex.ENCODED_STREAMS}

    def encode(s, fuse_satur, keep, payload):
        return ex.encode_blocked_inputs(s, p, keep_f32=keeps[keep],
                                        fuse_satur=fuse_satur,
                                        payload_dtype=getattr(torch, payload))

    def launch(label, enc, kernel=None):
        if label == "other":
            return oex.launch_cloudsc2_nl_encoded(enc, p)
        with build.variant(LIBRARY, variants[label]):
            return ex.launch_cloudsc2_nl_encoded(enc, p, kernel=kernel)

    if first:
        for what, (fuse_satur, keep, payload, kernel) in CHECKED.items():
            enc = encode(base, fuse_satur, keep, payload)
            decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, p)
            twin = (km.launch_cloudsc2_nl(decoded, pre, p) if fuse_satur
                    else km.launch_cloudsc2_fwd_ckpt(decoded, pre, p)[0])
            theirs = launch("other", enc)
            for v in variants:
                got = launch(v, enc, kernel)
                emit("check", build=v, encoding=what,
                     kernel=ex.nl_encoded_kernel(enc, kernel),
                     equal_other=all(torch.equal(a, b) for a, b in zip(got, theirs)),
                     equal_exact_on_decoded=all(torch.equal(a, b)
                                                for a, b in zip(got, twin)))
            del enc, decoded, pre, twin, theirs, got
            torch.cuda.empty_cache()

    pres = [km.kernel_prelude(s, p) for s in sets]
    encs = {what: [encode(s, *spec[:3]) for s in sets]
            for what, spec in TIMED.items() if what != "default_runtime"}
    encs["default_runtime"] = encs["default"]

    def time_build(label, turn):
        ms = {what: time_ms(lambda i: launch(label, encs[what][i], spec[3]),
                            len(sets), 30)
              for what, spec in TIMED.items()
              if label != "other" or spec[3] is None}
        emit("time", build=label, turn=turn, ncol=NCOL, ms=ms)

    def time_exact(turn):
        emit("time", build="exact", turn=turn, ncol=NCOL, ms={
            "exact": time_ms(lambda i: km.launch_cloudsc2_nl(sets[i], pres[i], p),
                             len(sets), 30)})

    order = ["other", *variants, *reversed(list(variants)), "other"]
    time_exact(1)
    for turn, label in enumerate(order):
        time_build(label, 1 + (turn >= len(order) // 2))
    time_exact(2)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--process"]:
        first = argv[1] == "1"
        return run_process(pathlib.Path(argv[2]), variants_of(argv[3:]), first)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other_root = pathlib.Path(argv[0]).resolve()
    rest = argv[1:]
    processes = int(rest.pop(0)) if rest and rest[0].isdigit() else 3
    readings = {}
    name = None
    for n in range(processes):
        proc = subprocess.run(
            [sys.executable, __file__, "--process", str(int(n == 0)),
             str(other_root), *rest], capture_output=True, text=True,
            cwd=ROOT, env=dict(os.environ), timeout=1800)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-5000:], file=sys.stderr)
            return 1
        per = {}
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            name = rec["card"]
            if rec["record"] == "check" and not (
                    rec["equal_other"] and rec["equal_exact_on_decoded"]):
                print(f"nl_enc_ab: a build disagrees: {rec}", file=sys.stderr)
                return 1
            if rec["record"] == "time":
                for what, ms in rec["ms"].items():
                    per.setdefault((rec["build"], what), []).append(ms)
        for key, values in per.items():
            readings.setdefault(key, []).append(statistics.mean(values))
    medians = {f"{b} {w}": statistics.median(v) for (b, w), v in readings.items()}
    print(json.dumps({"card": name, "processes": processes, "ncol": NCOL,
                      "readings": {f"{b} {w}": v for (b, w), v in readings.items()},
                      "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
