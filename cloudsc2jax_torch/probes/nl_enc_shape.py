"""The window probe at the encoded NL sweep's own access shape, beside the
exact and the encoded NL kernels, on one CUDA card.

Run from the root of a checkout that holds ``tests/fixtures``, on a machine
with one card::

    python3 cloudsc2jax_torch/probes/nl_enc_shape.py

Builds ``csrc/bw_probe.cu`` at 15 reads and 8 writes per level three ways
(``BW_PROBE_R16``): every read an f32 row (the exact NL sweep's shape), the
first 12 reads int16 rows (the default encoding's: 12 16-bit and 3 f32 rows a
level), every read an int16 row; each plain and with the NL body's chain (10
tanh and 292 flops an element).  At 327,680 columns and 137 levels it times,
by CUDA events over 20 launches after a warm-up, the six mixes, the exact NL
kernel, the encoded NL kernel at the default encoding and the exact NL
kernel on that encoding's decoded inputs (the same trajectory as the encoded
kernel's, read as f32), in turns (all of them, then all again in reverse
order), and prints one JSON line per timing
and a last line with the mean per name, the bytes each moves and the rate,
with the card's name and power limit.
"""
import ctypes
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
READS, WRITES = 15, 8
# name: (16-bit reads, tanh and flops per element)
MIXES = {"f32": (0, (0, 0)), "i16x12": (12, (0, 0)), "i16x15": (15, (0, 0)),
         "f32_weighted": (0, (10, 292)), "i16x12_weighted": (12, (10, 292)),
         "i16x15_weighted": (15, (10, 292))}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from cloudsc2jax_torch.bw_probe import probe_defines
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.probes.enc_ab import card
    from cloudsc2jax_torch.probes.tlad_budget import time_ms
    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("nl_enc_shape: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    specs = {mix: probe_defines(READS, WRITES, compute) + (f"BW_PROBE_R16={r16}",)
             for mix, (r16, compute) in MIXES.items()}
    build.load_libraries([("bw_probe", d) for d in specs.values()]
                         + ["cloudsc2_nl", "cloudsc2_nl_enc"])
    st = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    p = st.params
    base = st.device_kernel_inputs(NCOL, dtype=torch.float32, device="cuda",
                                   pqs=True)
    nlev = base.pt.shape[0]
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [km.kernel_prelude(s, p) for s in sets]
    encs = [ex.encode_blocked_inputs(s, p) for s in sets]
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = [torch.rand((nlev, NCOL), generator=gen, device="cuda")
           for _ in range(READS)]
    i16 = [torch.randint(-32767, 32768, (nlev, NCOL), generator=gen,
                         device="cuda", dtype=torch.int16) for _ in range(READS)]
    out = [torch.empty((nlev, NCOL), device="cuda") for _ in range(WRITES)]
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    calls, moved = {}, {}
    for mix, (r16, compute) in MIXES.items():
        lib = build.bind(
            "bw_probe", {"bw_probe_abi": (READS, WRITES, *compute)},
            {"bw_probe_f32": [ptrs, ptrs, ctypes.c_double, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]},
            defines=specs[mix])
        arrs = i16[:r16] + f32[r16:]

        def launch(i, lib=lib, arrs=arrs):
            build.launch(lib, "bw_probe", out[0], arrs, out, 1e-6 * (i + 1), NCOL,
                         nlev, 0)

        calls[mix] = launch
        moved[mix] = (2 * r16 + 4 * (READS - r16) + 4 * WRITES) * nlev * NCOL
    calls["exact_nl"] = lambda i: km.launch_cloudsc2_nl(sets[i], pres[i], p)
    moved["exact_nl"] = (4 * READS * nlev + 4 + 4 * WRITES * nlev) * NCOL
    calls["encoded_nl"] = lambda i: ex.launch_cloudsc2_nl_encoded(encs[i], p)
    moved["encoded_nl"] = sum(
        x.numel() * x.element_size()
        for x in (*encs[0].streams, encs[0].paphsfc, encs[0].ztrpaus)) + (
        4 * WRITES * nlev * NCOL)
    # the exact kernel on the trajectory the encoded kernel computes: what
    # the decoded values cost the level body, apart from the loads
    decoded = [ex.decode_inputs(e) for e in encs]
    dpres = [ex._prelude(e, p) for e in encs]
    calls["exact_nl_on_decoded"] = lambda i: km.launch_cloudsc2_nl(
        decoded[i], dpres[i], p)
    moved["exact_nl_on_decoded"] = moved["exact_nl"]
    readings = {}
    for turn, order in enumerate((list(calls), list(reversed(calls)))):
        for label in order:
            ms = time_ms(calls[label], len(sets), 20)
            readings.setdefault(label, []).append(ms)
            print(json.dumps({"card": name, "turn": turn + 1, "name": label,
                              "ms": ms}), flush=True)
    summary = {label: {"ms": statistics.mean(v), "bytes": moved[label],
                       "gb_per_s": moved[label] / (statistics.mean(v) * 1e-3) / 1e9}
               for label, v in readings.items()}
    print(json.dumps({"card": name, "ncol": NCOL, "nlev": nlev,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
