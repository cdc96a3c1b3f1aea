"""The encoded TL and AD kernels of this checkout against those of another,
in turns in one process, on one CUDA card.

Run from the root of a checkout that holds ``tests/fixtures``, on a machine
with one card, with another checkout unpacked by ``git archive`` into a
gitignored directory::

    python3 cloudsc2jax_torch/probes/enc_ab.py <root of the other checkout> [variant ...]

A variant is ``NAME=DEFINE[,DEFINE...]``: this checkout's encoded libraries
built with those ``-D`` defines (``tl8=CLOUDSC2_TL_ENC_MIN_BLOCKS_F32=8``).
The other checkout's package is loaded beside this one under another name,
with its own build; both run on encodings made by this checkout's encoder
(at 327,680 f32 columns, three input sets, the default encoding).

Prints JSON lines, each with the card's name and power limit:

* ``check``: every build's encoded TL (with and without primal streams) and
  AD outputs against the other checkout's and against this checkout's
  exact kernels on the decoded inputs, bit for bit;
* ``loop``: registers and spills (ptxas) of each build's work-unit entries
  (evaporation off, ``lregcl`` on), and the count of instructions and of
  each load and store opcode in their level loop (SASS), beside the exact
  kernels';
* ``sass``: per library of both checkouts but the encoded NL one (the
  window probe at its NL mix; this checkout's encoded TL and AD at their
  default build), the digest of each kernel entry's SASS, and whether they
  are equal;
* ``time``: ms per launch by CUDA events (20 launches cycling the three
  sets) of the exact TL and AD kernels and of each build's encoded TL, TL
  without primal streams and AD, in turns: other, this, the variants, the
  variants again, this, other; then the exact kernels again.
"""
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
# the libraries whose code is held against the other checkout's: every one
# but the encoded NL library, whose load policy the encoded TL and AD ones share
EXACT_LIBRARIES = ("cloudsc2_nl", "cloudsc2_nl_res", "cloudsc2_tl",
                   "cloudsc2_tl_din", "cloudsc2_ad", "cloudsc2_tl_enc",
                   "cloudsc2_ad_enc", "cloudsc2_tlad_fused", "bw_probe")
# work-unit entries: evaporation off, lregcl on (TL with primal streams)
MARKS = {"tl": ("cloudsc2_tl_kernel", "IfLb0ELb1ELb1E"),
         "ad": ("cloudsc2_ad_kernel", "IfLb0ELb1E"),
         "tl_enc": ("cloudsc2_tl_enc_kernel", "Lb0ELb1ELb1E"),
         "ad_enc": ("cloudsc2_ad_enc_kernel", "Lb0ELb1E")}
LOADS = ("LDG", "LDC", "ULDC", "LDS", "STS", "STG", "LDL", "STL")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def load_other(root: pathlib.Path):
    """The other checkout's package, imported as ``other_cloudsc2jax_torch``
    (its modules import each other relatively, and its build module builds
    from its own sources into its own build directory)."""
    pkg = root / "cloudsc2jax_torch"
    spec = importlib.util.spec_from_file_location(
        "other_cloudsc2jax_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from cloudsc2jax_torch.bw_probe import probe_defines
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("enc_ab: no CUDA device", file=sys.stderr)
        return 2
    other_root = pathlib.Path(argv[0]).resolve()
    variants = {"this": ()}
    for spec in argv[1:]:
        label, _, defines = spec.partition("=")
        variants[label] = tuple(defines.split(","))
    name = card()

    def emit(what, **record):
        print(json.dumps({"record": what, "card": name, **record}), flush=True)

    other = load_other(other_root)
    obuild = importlib.import_module(other.__name__ + ".kernels.build")
    oex = importlib.import_module(other.__name__ + ".kernels.experiments")
    mix = probe_defines(15, 8, (0, 0))
    exact = [(lib, mix if lib == "bw_probe" else ()) for lib in EXACT_LIBRARIES]
    build.load_libraries(exact + [(lib, d) for lib in ("cloudsc2_tl_enc",
                                                       "cloudsc2_ad_enc")
                                  for d in variants.values()])
    obuild.load_libraries(exact + ["cloudsc2_tl_enc", "cloudsc2_ad_enc"])

    # -- the exact libraries' code, this checkout against the other
    for lib, defines in exact:
        mine = build.sass_digests(build.sass(lib, defines))
        theirs = build.sass_digests(obuild.sass(lib, defines))
        emit("sass", library=lib, equal=mine == theirs, entries=len(mine),
             digest=build.library_digest(mine),
             differ=sorted(e for e in mine if mine[e] != theirs.get(e)))

    # -- registers, spills and level loops of the work-unit entries: the
    # exact kernels, the other checkout's encoded ones (instances of the
    # exact kernels' templates there) and this checkout's builds
    rows = [("exact", build, kind, lib, (), MARKS[kind])
            for kind, lib in (("tl", "cloudsc2_tl"), ("ad", "cloudsc2_ad"))]
    rows += [("other", obuild, kind, lib, (), MARKS[kind[:2]])
             for kind, lib in (("tl_enc", "cloudsc2_tl_enc"),
                               ("ad_enc", "cloudsc2_ad_enc"))]
    rows += [(v, build, kind, lib, d, MARKS[kind]) for v, d in variants.items()
             for kind, lib in (("tl_enc", "cloudsc2_tl_enc"),
                               ("ad_enc", "cloudsc2_ad_enc"))]
    for label, b, kind, lib, defines, marks in rows:
        text = b.sass(lib, defines)
        for e in b.ptxas_report(lib, defines):
            if not all(m in e["entry"] for m in marks):
                continue
            c = build.loop_census(text, [e["entry"]])
            emit("loop", build=label, kind=kind, entry=e["entry"],
                 registers=e.get("registers"),
                 spill_store_bytes=e.get("spill_store_bytes"),
                 spill_load_bytes=e.get("spill_load_bytes"),
                 loop_instructions=c["instructions"],
                 loop_ops={op: c["ops"].get(op, 0) for op in LOADS})

    # -- inputs, encodings, and the checks
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    base = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    encs = [ex.encode_blocked_inputs(s, p, fuse_satur=False) for s in sets]
    decoded = [ex.decode_inputs(e) for e in encs]
    pres = [ex._prelude(e, p) for e in encs]
    seeds = [tk.launch_cloudsc2_tl(d, q, p, dscale=DSCALE) for d, q in zip(decoded, pres)]

    def run(lib_ex, v, e, s, wp=True):
        with build.variant("cloudsc2_tl_enc", v), build.variant("cloudsc2_ad_enc", v):
            o, do, ck = lib_ex.launch_cloudsc2_tl_encoded(e, p, dscale=DSCALE,
                                                          write_primal=wp)
            adj = lib_ex.launch_cloudsc2_ad_encoded(e, s[1], s[2], p)
        return [*(o or ()), *do, *ck, *adj]

    adj = tk.launch_cloudsc2_ad(decoded[0], pres[0], seeds[0][1], seeds[0][2], p)
    _, do_n, ck_n = tk.launch_cloudsc2_tl(decoded[0], pres[0], p, dscale=DSCALE,
                                          write_primal=False)
    want = [*seeds[0][0], *seeds[0][1], *seeds[0][2], *adj]
    want_n = [*do_n, *ck_n, *adj]
    theirs = run(oex, (), encs[0], seeds[0])

    def same(xs, ys):
        return all(torch.equal(a, b) for a, b in zip(xs, ys))

    for v, d in variants.items():
        got = run(ex, d, encs[0], seeds[0])
        nop = run(ex, d, encs[0], seeds[0], wp=False)
        emit("check", build=v, equal_other=same(got, theirs),
             equal_exact_on_decoded=same(got, want),
             equal_exact_on_decoded_without_primal=same(nop, want_n))
    del theirs, got, nop, want, want_n

    # -- timing in turns
    def time_ms(fn, calls=20):
        for i in range(len(sets)):
            fn(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in range(calls):
            fn(c % len(sets))
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / calls

    def time_build(label):
        lib_ex, d = (oex, ()) if label == "other" else (ex, variants[label])
        with build.variant("cloudsc2_tl_enc", d), build.variant("cloudsc2_ad_enc", d):
            ms = {
                "tl_enc": time_ms(lambda i: lib_ex.launch_cloudsc2_tl_encoded(
                    encs[i], p, dscale=DSCALE)),
                "tl_enc_noprim": time_ms(lambda i: lib_ex.launch_cloudsc2_tl_encoded(
                    encs[i], p, dscale=DSCALE, write_primal=False)),
                "ad_enc": time_ms(lambda i: lib_ex.launch_cloudsc2_ad_encoded(
                    encs[i], seeds[i][1], seeds[i][2], p)),
            }
        emit("time", build=label, ncol=NCOL, ms=ms)

    def time_exact(turn):
        emit("time", build="exact", turn=turn, ncol=NCOL, ms={
            "tl": time_ms(lambda i: tk.launch_cloudsc2_tl(decoded[i], pres[i], p,
                                                          dscale=DSCALE)),
            "ad": time_ms(lambda i: tk.launch_cloudsc2_ad(
                decoded[i], pres[i], seeds[i][1], seeds[i][2], p))})

    order = ["other", *variants, *reversed(list(variants)), "other"]
    time_exact(1)
    for label in order:
        time_build(label)
    time_exact(2)
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
