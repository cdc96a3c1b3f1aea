"""Register budgets of the TL and AD sweeps on one CUDA card.

Run from the root of a checkout, on a machine with one card::

    python3 cloudsc2jax_torch/probes/tlad_budget.py [sweep] [ad|tl|din|tl_enc|ad_enc ...]

It builds each kernel once per budget (blocks of 128 threads per SM that
the register budget must allow, ``-DCLOUDSC2_*_MIN_BLOCKS_F32``), all nvcc
runs started together, and prints one JSON line per build at 327,680 f32
columns (``lregcl`` on, ldrain1d off, the work unit's body): registers,
spill bytes, the warps per SM those registers and the block's shared
memory allow (64K registers, 228 KB of shared memory with 1 KB reserved per
block, 16 blocks of 128 threads), the shared bytes per block and the
kernel's time by CUDA events over 20 launches on three input sets.  Kinds:
``ad`` (cloudsc2_ad.cu), ``tl`` (cloudsc2_tl.cu, in-register increments,
primal streams written), ``din`` (cloudsc2_tl_din.cu, streamed
increments), ``tl_enc`` (cloudsc2_tl_enc.cu, the int16-encoded TL with
primal streams, default encoding) and ``ad_enc`` (cloudsc2_ad_enc.cu, the
encoded AD from the encoded TL's checkpoints).  A block's shared memory is
the AD body's slots.  Every line carries the card's name and power limit.
"""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
# min blocks of each kind's sweep
SWEEP = {"ad": (3, 4, 5, 6), "tl": (5, 6, 7, 8), "din": (6, 7, 8),
         "tl_enc": (6, 7, 8, 9), "ad_enc": (4, 5, 6)}
LIBRARY = {"ad": "cloudsc2_ad", "tl": "cloudsc2_tl", "din": "cloudsc2_tl_din",
           "tl_enc": "cloudsc2_tl_enc", "ad_enc": "cloudsc2_ad_enc"}
_MACRO = {"ad": "CLOUDSC2_AD", "tl": "CLOUDSC2_TL", "din": "CLOUDSC2_TL_DIN",
          "tl_enc": "CLOUDSC2_TL_ENC", "ad_enc": "CLOUDSC2_AD_ENC"}
# the f32 entry of the work unit's body (evap off, lregcl on; TL with primal;
# the encoded kernels at the default encoding's mask, 0x3FFD, which has a
# kernel of its own)
_DEFAULT_MASK = "N13cloudsc2_load14EncodedLevelsTILj16381EEE"
ENTRY = {"ad": ("cloudsc2_ad_kernel", "IfLb0ELb1EN13cloudsc2_load5ExactE"),
         "tl": ("cloudsc2_tl_kernel", "IfLb0ELb1ELb1EN13cloudsc2_load5ExactE"),
         "din": ("cloudsc2_tl_din_kernel", "IfLb0ELb1EE"),
         "tl_enc": ("cloudsc2_tl_enc_kernel", "ILb0ELb1ELb1E" + _DEFAULT_MASK),
         "ad_enc": ("cloudsc2_ad_enc_kernel", "ILb0ELb1E" + _DEFAULT_MASK)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def budget_defines(kind: str, blocks: int):
    """The -D define of one budget of ``kind``."""
    return (f"{_MACRO[kind]}_MIN_BLOCKS_F32={blocks}",)


def stash_slots() -> int:
    """Shared slots per thread of the work unit's AD body."""
    import re

    from cloudsc2jax_torch.kernels import emit

    text = emit.HEADERS["ad"].read_text()
    return int(re.search(r"lregcl: false, true \(\d+ statements, live peak \d+, "
                         r"(\d+) shared slots", text).group(1))


def entry_report(kind: str, defines=(), flags=()) -> dict:
    """ptxas' registers and spills of ``kind``'s work-unit entry."""
    from cloudsc2jax_torch.kernels import build

    name, mark = ENTRY[kind]
    for e in build.ptxas_report(LIBRARY[kind], defines, flags):
        if name in e["entry"] and mark in e["entry"]:
            return e
    raise AssertionError(f"no {name}<{mark}> entry in {LIBRARY[kind]}'s report")


def warps_per_sm(registers: int, shared_bytes: int) -> int:
    """Warps of 128-thread blocks an H100 SM holds at these registers and
    this much dynamic shared memory per block."""
    by_regs = 65536 // (-(-registers // 8) * 8 * 128)
    by_smem = 232_448 // (shared_bytes + 1024) if shared_bytes else 32
    return 4 * min(by_regs, by_smem, 16)


def time_ms(fn, n_sets: int, calls: int = 20) -> float:
    """Mean device time per call of ``fn(i)`` over ``calls`` calls cycling
    through ``n_sets`` input sets, after one warm call per set."""
    import torch

    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for c in range(calls):
        fn(c % n_sets)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


class Unit:
    """Three distinct f32 input sets at ``ncol`` columns, their preludes,
    increments, TL images, encodings and encoded TL images (by the default
    builds), and a launcher per kind."""

    def __init__(self, state, ncol: int = NCOL):
        import torch

        from cloudsc2jax_torch.drivers import DSCALE
        from cloudsc2jax_torch.kernels import experiments as ex
        from cloudsc2jax_torch.kernels import tlad_kernel as tk
        from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
        from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

        self.params = p = state.params
        base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                          pqs=True)
        self.sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                              for s in (37, 71)]
        self.pres = [kernel_prelude(s, p) for s in self.sets]
        self.dsets = [Cloudsc2Inputs(*(DSCALE * x for x in s)) for s in self.sets]
        self.tls = [tk.launch_cloudsc2_tl(i, q, p, dscale=DSCALE)
                    for i, q in zip(self.sets, self.pres)]
        self.encs = [ex.encode_blocked_inputs(s, p, fuse_satur=False)
                     for s in self.sets]
        self.enc_tls = [ex.launch_cloudsc2_tl_encoded(e, p, dscale=DSCALE)
                        for e in self.encs]
        self.launch = {
            "ad": lambda i: tk.launch_cloudsc2_ad(
                self.sets[i], self.pres[i], self.tls[i][1], self.tls[i][2], p),
            "tl": lambda i: tk.launch_cloudsc2_tl(self.sets[i], self.pres[i], p,
                                                  dscale=DSCALE),
            "din": lambda i: tk.launch_cloudsc2_tl_din(
                self.sets[i], self.dsets[i], self.pres[i], p, lregcl=True),
            "tl_enc": lambda i: ex.launch_cloudsc2_tl_encoded(
                self.encs[i], p, dscale=DSCALE),
            "ad_enc": lambda i: ex.launch_cloudsc2_ad_encoded(
                self.encs[i], self.enc_tls[i][1], self.enc_tls[i][2], p),
        }

    def time(self, kind: str, calls: int = 20) -> float:
        return time_ms(self.launch[kind], len(self.sets), calls)


def sweep(kinds, state) -> list:
    """The budget table of ``kinds``: one dict per build."""
    from cloudsc2jax_torch.kernels import build

    build.load_libraries(["cloudsc2_tl", "cloudsc2_tl_enc"]
                         + [(LIBRARY[k], budget_defines(k, b))
                            for k in kinds for b in SWEEP[k]])
    unit = Unit(state)
    rows = []
    for kind in kinds:
        slots = stash_slots() if kind in ("ad", "ad_enc") else 0
        for blocks in SWEEP[kind]:
            defines = budget_defines(kind, blocks)
            e = entry_report(kind, defines)
            shared = slots * 4 * 128
            with build.variant(LIBRARY[kind], defines):
                ms = unit.time(kind)
            row = {"kind": kind, "min_blocks": blocks,
                   "registers": e["registers"],
                   "spill_store_bytes": e["spill_store_bytes"],
                   "spill_load_bytes": e["spill_load_bytes"],
                   "shared_bytes_per_block": shared,
                   "warps_per_sm": warps_per_sm(e["registers"], shared),
                   "ms": ms, "ncol": NCOL}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("tlad_budget: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    print(name, flush=True)
    state = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    kinds = argv[1:] if argv[:1] == ["sweep"] else argv
    unknown = sorted(set(kinds) - set(SWEEP))
    if unknown:
        print(f"tlad_budget: unknown kinds {unknown}", file=sys.stderr)
        return 2
    rows = sweep(kinds or list(SWEEP), state)
    print(json.dumps({"card": name, "sweep": rows}))
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
