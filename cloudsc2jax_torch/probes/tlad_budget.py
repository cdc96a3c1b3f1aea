"""Register budgets of the TL and AD sweeps, and the A/B of the shipped
schedule against the earlier traced one, on one CUDA card.

Run from the root of a checkout, on a machine with one card::

    python3 cloudsc2jax_torch/probes/tlad_budget.py sweep [ad|adtrace|tl|din ...]
    python3 cloudsc2jax_torch/probes/tlad_budget.py ab

and, on any machine, ``python3 cloudsc2jax_torch/probes/tlad_budget.py
render``: the traced AD bodies rendered under ``build/tlad_budget/`` and the
build variants that rebuild the traced schedule, printed as JSON.

``sweep`` builds each kernel once per budget (blocks of 128 threads per SM
that the register budget must allow, ``-DCLOUDSC2_*_MIN_BLOCKS_F32``), all
nvcc runs started together, and prints one JSON line per build at
327,680 f32 columns (``lregcl`` on, ldrain1d off, the work unit's body):
registers, spill bytes, the warps per SM those registers and the block's
shared memory allow (64K registers, 228 KB of shared memory with 1 KB
reserved per block, 16 blocks of 128 threads), the shared bytes per block
and the kernel's time by CUDA events over 20 launches on three input sets.
Kinds: ``ad`` (cloudsc2_ad.cu with the shipped AD bodies), ``adtrace``
(the same kernel with the AD bodies in the traced order, as they were
first printed), ``tl`` (cloudsc2_tl.cu, in-register increments, primal
streams written), ``din`` (cloudsc2_tl_din.cu, streamed increments).  A
block's shared memory is the AD body's slots.

``ab`` times the shipped kernels against the traced schedule they
replaced, rebuilt from this checkout: the AD bodies rendered by the
emitter in the traced order (``emit.render_header("ad", ...,
schedule="trace")``, written under ``build/tlad_budget/`` and put first on
the include path) and the old budgets (AD 3 blocks, TL the block size
alone), in turns traced_schedule, change, change, traced_schedule for each
kernel; then ``run_tlad`` on the stream contract in six processes of their
own, the two schedules in turns, each the mean of 10 calls after a warm
call.  chip_smoke.py runs the same A/B as a phase.

Every line carries the card's name and power limit.
"""
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NCOL = 327_680
WORK = ROOT / "build" / "tlad_budget"
# min blocks of each kind's sweep
SWEEP = {"ad": (3, 4, 5, 6), "adtrace": (3, 4, 5), "tl": (5, 6, 7, 8),
         "din": (6, 7, 8)}
LIBRARY = {"ad": "cloudsc2_ad", "adtrace": "cloudsc2_ad", "tl": "cloudsc2_tl",
           "din": "cloudsc2_tl_din"}
_MACRO = {"ad": "CLOUDSC2_AD", "adtrace": "CLOUDSC2_AD", "tl": "CLOUDSC2_TL",
          "din": "CLOUDSC2_TL_DIN"}
# the f32 entry of the work unit's body (evap off, lregcl on; TL with primal)
_AD_ENTRY = ("cloudsc2_ad_kernel", "IfLb0ELb1EN13cloudsc2_load5ExactE")
ENTRY = {"ad": _AD_ENTRY, "adtrace": _AD_ENTRY,
         "tl": ("cloudsc2_tl_kernel", "IfLb0ELb1ELb1EN13cloudsc2_load5ExactE"),
         "din": ("cloudsc2_tl_din_kernel", "IfLb0ELb1EE")}
# the traced schedule, the baseline of the A/B, and this tree's
OLD, NEW = "traced_schedule", "change"
AB_ORDER = (OLD, NEW, NEW, OLD)
UNIT_ORDER = (OLD, NEW, NEW, OLD, OLD, NEW)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def budget_defines(kind: str, blocks: int):
    """The -D define of one budget of ``kind``."""
    return (f"{_MACRO[kind]}_MIN_BLOCKS_F32={blocks}",)


def traced_ad_bodies():
    """The nvcc flags and define that build cloudsc2_ad.cu (and the kernels
    that share its sweep) with the AD bodies in the traced order: the
    header, written under build/ and named by its content, first on the
    include path."""
    from cloudsc2jax_torch.kernels import build, emit

    text = emit.render_header("ad", {v: emit.trace("ad", *v) for v in emit.VARIANTS},
                              schedule="trace")
    include = WORK / hashlib.sha256(text.encode()).hexdigest()[:16]
    include.mkdir(parents=True, exist_ok=True)
    (include / "cloudsc2_ad_level.cuh").write_text(text)
    return ("CLOUDSC2_LEVEL_FROM_INCLUDE_PATH=1",), (f"-I{include}", f"-I{build.CSRC}")


def stash_slots(traced: bool = False) -> int:
    """Shared slots per thread of the work unit's AD body."""
    import re

    from cloudsc2jax_torch.kernels import emit

    if traced:
        return 0
    text = emit.HEADERS["ad"].read_text()
    return int(re.search(r"lregcl: false, true \(\d+ statements, live peak \d+, "
                         r"(\d+) shared slots", text).group(1))


def traced_variants():
    """build.variant arguments, by library, that rebuild the traced schedule
    from this checkout: the AD bodies in the traced order with 3 blocks,
    the TL kernels bounded by their block size alone (a budget of 0)."""
    define, flags = traced_ad_bodies()
    return {
        "cloudsc2_ad": (budget_defines("ad", 3) + define, flags),
        "cloudsc2_tl": (budget_defines("tl", 0), ()),
        "cloudsc2_tl_din": (budget_defines("din", 0), ()),
    }


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
    increments and TL images, and a launcher per kind."""

    def __init__(self, state, ncol: int = NCOL):
        import torch

        from cloudsc2jax_torch.drivers import DSCALE
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
        self.launch = {
            "ad": lambda i: tk.launch_cloudsc2_ad(
                self.sets[i], self.pres[i], self.tls[i][1], self.tls[i][2], p),
            "adtrace": lambda i: self.launch["ad"](i),
            "tl": lambda i: tk.launch_cloudsc2_tl(self.sets[i], self.pres[i], p,
                                                  dscale=DSCALE),
            "din": lambda i: tk.launch_cloudsc2_tl_din(
                self.sets[i], self.dsets[i], self.pres[i], p, lregcl=True),
        }

    def time(self, kind: str, calls: int = 20) -> float:
        return time_ms(self.launch[kind], len(self.sets), calls)


def sweep(kinds, state) -> list:
    """The budget table of ``kinds``: one dict per build."""
    from cloudsc2jax_torch.kernels import build

    traced = traced_ad_bodies() if "adtrace" in kinds else ((), ())

    def spec(kind, blocks):
        defines = budget_defines(kind, blocks)
        return ((defines + traced[0], traced[1]) if kind == "adtrace"
                else (defines, ()))

    build.load_libraries([(LIBRARY[k], *spec(k, b)) for k in kinds for b in SWEEP[k]])
    unit = Unit(state)
    rows = []
    for kind in kinds:
        slots = stash_slots(kind == "adtrace") if kind.startswith("ad") else 0
        for blocks in SWEEP[kind]:
            defines, flags = spec(kind, blocks)
            e = entry_report(kind, defines, flags)
            shared = slots * 4 * 128
            with build.variant(LIBRARY[kind], defines, flags):
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


def ab_kernels(state, old) -> dict:
    """Each kernel's time in the turns of AB_ORDER, with both builds' ptxas
    lines: ``{kind: {OLD: [ms, ms], NEW: [ms, ms], "ptxas": {...}}}``;
    ``old`` is :func:`traced_variants`."""
    from cloudsc2jax_torch.kernels import build

    unit = Unit(state)
    out = {}
    for kind in ("ad", "tl", "din"):
        lib = LIBRARY[kind]
        times = {OLD: [], NEW: []}
        for label in AB_ORDER:
            with build.variant(lib, *(old[lib] if label == OLD else ((), ()))):
                times[label].append(unit.time(kind))
        with build.variant(lib, *old[lib]):
            o_entry = entry_report(kind)
        n_entry = entry_report(kind)
        out[kind] = {**times, "ptxas": {OLD: o_entry, NEW: n_entry}}
        print(f"A/B {kind}: {OLD} {times[OLD]} ms, {NEW} {times[NEW]} ms; "
              f"registers {o_entry['registers']} -> {n_entry['registers']}, "
              f"spill stores {o_entry['spill_store_bytes']} -> "
              f"{n_entry['spill_store_bytes']} B", flush=True)
    return out


def ab_units(old, root=ROOT) -> dict:
    """``run_tlad`` (stream contract, 327,680 f32 columns) in processes of
    their own, in the turns of UNIT_ORDER: ``{label: [ms per process],
    label + "_median": ms}``."""
    res = {OLD: [], NEW: []}
    for label in UNIT_ORDER:
        spec = json.dumps(old if label == OLD else {})
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "unit", spec],
            capture_output=True, text=True, cwd=root, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"run_tlad process ({label}) failed:\n{proc.stderr[-3000:]}")
        res[label].append(json.loads(proc.stdout.strip().splitlines()[-1])["run_tlad_ms"])
    for label in (OLD, NEW):
        res[label + "_median"] = statistics.median(res[label])
    print(f"A/B run_tlad: {OLD} {res[OLD]} (median {res[OLD + '_median']:.4f}) ms, "
          f"{NEW} {res[NEW]} (median {res[NEW + '_median']:.4f}) ms", flush=True)
    return res


def unit_process(spec: str) -> None:
    """One process's ``run_tlad`` time under the build variants ``spec``
    (JSON: library -> [defines, flags]); prints ``{"run_tlad_ms": ...}``."""
    import contextlib

    from cloudsc2jax_torch.drivers import run_tlad
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.state import Cloudsc2State

    state = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    with contextlib.ExitStack() as stack:
        for lib, (defines, flags) in json.loads(spec).items():
            stack.enter_context(build.variant(lib, defines, flags))
        unit = Unit(state)
        ms = time_ms(lambda i: run_tlad(unit.sets[i], unit.params), len(unit.sets), 10)
    print(json.dumps({"run_tlad_ms": ms}))


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["unit"]:
        unit_process(argv[1])
        return 0
    if argv[:1] == ["render"]:  # the traced schedule's build variants, on any machine
        print(json.dumps(traced_variants()))
        return 0
    import torch

    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.state import Cloudsc2State

    if not torch.cuda.is_available():
        print("tlad_budget: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    print(name, flush=True)
    state = Cloudsc2State.load(ROOT / "tests" / "fixtures" / "input.npz")
    mode = argv[0] if argv else "sweep"
    if mode == "sweep":
        kinds = argv[1:] or list(SWEEP)
        rows = sweep(kinds, state)
        print(json.dumps({"card": name, "sweep": rows}))
    elif mode == "ab":
        old = traced_variants()
        build.load_libraries([(lib, *spec) for lib, spec in old.items()]
                             + list(LIBRARY.values()))
        res = {"kernels": ab_kernels(state, old), "run_tlad": ab_units(old)}
        print(json.dumps({"card": name, "ab": res}))
    else:
        print(f"tlad_budget: unknown mode {mode!r}", file=sys.stderr)
        return 2
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
