"""The system's benchmark on one card: columns per second of a variant.

Port of the JAX package's ``bench.py``::

    python -m cloudsc2jax_torch.bench [--device cuda|cpu] [--nlev N]

prints ONE JSON line on standard output (everything else goes to standard
error).  ``CLOUDSC2_BENCH_VARIANT`` picks the variant:

* ``nl`` (the default): ``run_nl(backend="streams")``, the main path, on
  ``Cloudsc2State.synthetic(ngptot=100)`` expanded on the device to
  ``CLOUDSC2_BENCH_NGPTOT`` f32 columns (default 327,680).  Every call gets
  distinct inputs: ``pt`` alone is bumped by a small time-salted amount for
  each of the 10 warm-up calls and the ``CLOUDSC2_BENCH_REPEATS`` (default
  20) timed ones (a bumped copy of all 16 streams per call would not fit
  the card).  The warm-up is itself a chain read once; the timed chain
  reduces each call to a scalar with the slice probe
  (``drivers.slice_probe``), adds it to one device accumulator and reads it
  once, under the host's clock.
* ``tlad``: ``run_tlad(backend="streams", lregcl=True)`` with the same
  method.  ``CLOUDSC2_BENCH_WRITE_PRIMAL`` defaults to 0 on the card (the
  reference AD driver's contract, ``impl`` ``streams_noprim``, as the JAX
  bench defaults on its chip) and to 1 on the CPU.  With
  ``CLOUDSC2_BENCH_F32_CHECKS=1`` (the default) the record carries the f32
  verdicts of ``cli.measure_f32_verdicts`` at ``min(ngptot, 16384)``
  columns with their margins against the CLI's tolerances.
* ``CLOUDSC2_BENCH_PALLAS=0`` (``bench.py:108-191``) times the truth path
  instead, ``impl`` ``truth``: ``run_nl(backend="truth")`` for ``nl`` and
  ``run_tlad(backend="truth")`` (its ``vjp`` level-checkpointed) for
  ``tlad``, on the standard ``(ncol, nlev)`` contract
  (``state.device_inputs``).  It is bound by the host; give it a small
  ``CLOUDSC2_BENCH_NGPTOT`` and ``_REPEATS``.
* For ``nl``, ``CLOUDSC2_BENCH_MODE=resident`` times kernel #2, the
  resident sweep (``kernels.experiments.cloudsc2_nl_resident`` at its
  default ring), on levels-major inputs with pqs, ``impl`` ``resident``;
  ``CLOUDSC2_BENCH_LAYOUT=standard`` times the standard contract,
  ``run_nl(backend="kernels")`` on transposed views, ``impl`` ``kernels``
  (the JAX bench's ``pallas``).  The two do not combine.
* The warm-up is as many calls as the timed chain, at most 10.
* ``chunked`` and ``chunked_tlad``: ``drivers.run_chunked`` of ``nl`` or
  ``tlad`` over ``CLOUDSC2_BENCH_NGPTOT`` columns (default 10,485,760 on
  the card: 32 chunks of ``CLOUDSC2_BENCH_CHUNK`` = 327,680, about 132 GB
  of NL streams and 290 GB of TL+AD streams, past the 80 GB of an H100),
  one warm pass, then ``CLOUDSC2_BENCH_REPEATS`` timed passes, each read
  once.  ``CLOUDSC2_BENCH_MESH=1`` (the default, ``bench.py:386-415``)
  decomposes every chunk over a column mesh of every card of the machine
  (``dist.column_mesh``; one lane on the CPU), ``0`` runs without a mesh;
  ``value`` is then per card, ``mesh_columns_per_second`` the mesh's and
  ``mesh_devices`` its lanes.  The record adds the peak of allocated device
  memory (the largest of the cards'), the bytes the chunks stream and a
  card's memory.

Every record names its card (``device_name``, ``power_limit_w`` from
``nvidia-smi``); ``vs_baseline`` divides by the reference's estimated
300,000 columns/s of four CPU threads, and the ``baseline`` block is read
from ``BASELINE_MEASURED.json`` at the root of the checkout.  ``bytes_
accessed_gb`` counts the tensors a timed call reads and writes, each once
(its inputs and its results).

``--device cpu`` runs the plain PyTorch versions at shrunken defaults
(8,192 columns; chunked: 2,048 columns, chunk ``min(327680, ngptot)``, 17
levels, ``sublanes`` 1), for the tests: its numbers say nothing about a
card.  ``--nlev`` changes the levels of the synthetic state (137 is the
model's).

Left out of the JAX bench, on purpose:

* the TPU preflight in a subprocess and the fall back to the CPU: a card
  that is asked for and missing is an error (exit code non-zero), never a
  CPU record;
* the ``except`` that prints a failed f32-verdict measurement and goes on:
  here it fails the run, as any failure in a phase does;
* the retry in a fresh process after a TPU backend error;
* ``CLOUDSC2_BENCH_FUSE_SATUR=0``, refused: the NL kernel always computes
  qsat (a recorded departure, ROADMAP section 3);
* ``CLOUDSC2_BENCH_SUBLANES``, refused: a TPU tile, where one CUDA thread
  owns one column.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

# the reference's estimate for four strong OpenMP threads, from its own
# ZHPM flop accounting: the vs_baseline denominator of every record
BASELINE_COLS_PER_S = 300_000.0

BASELINE_MEASURED = pathlib.Path(__file__).resolve().parents[1] / "BASELINE_MEASURED.json"

VARIANTS = ("nl", "tlad", "chunked", "chunked_tlad")

# warm-up calls of the nl and tlad chains, at most
WARM_CALLS = 10

# CLOUDSC2_BENCH_MODE and _LAYOUT values; the first of each is the default
MODES = ("stream", "resident")
LAYOUTS = ("blocked", "standard")


def nbytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (nested tuples; ``None`` skipped)."""
    total = 0
    for t in trees:
        if t is None:
            continue
        if hasattr(t, "numel"):
            total += t.numel() * t.element_size()
        else:
            total += nbytes(*t)
    return total


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(", ")
    return {"device_name": name, "power_limit_w": float(limit.split()[0])}


def _baseline(cols_per_s: float) -> dict:
    if not BASELINE_MEASURED.is_file():
        print(f"bench: {BASELINE_MEASURED.name} not found; no 'baseline' block",
              file=sys.stderr)
        return {}
    m = json.loads(BASELINE_MEASURED.read_text())
    return {
        "baseline": {
            "estimate_cols_per_s": BASELINE_COLS_PER_S,
            "measured_numpy_port_cols_per_s": m["numpy_port_cols_per_s"],
            "measured_xla_cpu_f64_cols_per_s": m["xla_cpu_f64_cols_per_s"],
            "provenance": "tools/measure_baseline.py (single-core host)",
        },
        "vs_measured_xla_cpu_f64": cols_per_s / m["xla_cpu_f64_cols_per_s"],
    }


def _unit(variant: str, state, ngptot: int, device, impl: str):
    """``(inputs, fn)`` of one timed call of ``impl``."""
    import torch

    from .drivers import run_nl, run_tlad
    from .kernels.experiments import cloudsc2_nl_resident

    params = state.params
    if impl == "truth":
        inputs = state.device_inputs(ngptot, dtype=torch.float32, device=device)
        if variant == "tlad":
            return inputs, lambda v: run_tlad(v, params, lregcl=True, backend="truth")
        return inputs, lambda v: run_nl(v, params, backend="truth")
    if impl == "kernels":
        inputs = state.device_inputs(ngptot, dtype=torch.float32, device=device)
        return inputs, lambda v: run_nl(v, params, backend="kernels")
    inputs = state.device_kernel_inputs(ngptot, dtype=torch.float32, device=device,
                                        pqs=variant == "tlad" or impl == "resident")
    if impl == "resident":
        return inputs, lambda v: cloudsc2_nl_resident(v, params)
    if variant == "tlad":
        wp = impl == "streams"
        return inputs, lambda v: run_tlad(v, params, lregcl=True, write_primal=wp)
    return inputs, lambda v: run_nl(v, params, backend="streams")


def _unit_impl(variant: str, gpu: bool) -> str:
    """The implementation that ``CLOUDSC2_BENCH_PALLAS``, ``_MODE``,
    ``_LAYOUT`` and ``_WRITE_PRIMAL`` select for ``nl`` or ``tlad``; raises
    SystemExit for the knobs the port refuses."""
    env = os.environ.get
    if env("CLOUDSC2_BENCH_FUSE_SATUR", "1") != "1":
        raise SystemExit("CLOUDSC2_BENCH_FUSE_SATUR=0: the NL kernel always "
                         "computes qsat from pt and pap (no streamed-pqs "
                         "variant of the main path)")
    if env("CLOUDSC2_BENCH_SUBLANES") is not None:
        raise SystemExit("CLOUDSC2_BENCH_SUBLANES is a TPU tile; one CUDA "
                         "thread owns one column")
    mode, layout = env("CLOUDSC2_BENCH_MODE", MODES[0]), env(
        "CLOUDSC2_BENCH_LAYOUT", LAYOUTS[0])
    if mode not in MODES or layout not in LAYOUTS:
        raise SystemExit(f"CLOUDSC2_BENCH_MODE must be one of {MODES} and "
                         f"_LAYOUT one of {LAYOUTS}, not {mode!r}, {layout!r}")
    if env("CLOUDSC2_BENCH_PALLAS", "1") != "1":
        return "truth"
    if (mode, layout) != (MODES[0], LAYOUTS[0]):
        if variant != "nl" or (mode, layout) == (MODES[1], LAYOUTS[1]):
            raise SystemExit("CLOUDSC2_BENCH_MODE=resident and _LAYOUT=standard "
                             "apply to the nl variant, one at a time")
        return "resident" if mode == MODES[1] else "kernels"
    if variant == "tlad":
        wp = env("CLOUDSC2_BENCH_WRITE_PRIMAL", "0" if gpu else "1") == "1"
        return "streams" if wp else "streams_noprim"
    return "streams"


def bench_unit(variant: str, device, nlev: int, repeats: int) -> dict:
    """The ``nl`` and ``tlad`` variants: one call over ``ngptot`` columns."""
    import numpy as np
    import torch

    from .drivers import slice_probe
    from .state import Cloudsc2State

    gpu = device.type == "cuda"
    platform = "gpu" if gpu else "cpu"
    impl = _unit_impl(variant, gpu)
    ngptot = int(os.environ.get("CLOUDSC2_BENCH_NGPTOT", 327680 if gpu else 8192))
    state = Cloudsc2State.synthetic(ngptot=100, nlev=nlev)
    tlad = variant == "tlad"
    inputs, fn = _unit(variant, state, ngptot, device, impl)

    # time-salted bumps: no two calls read the same inputs, in this run or
    # another
    rng = np.random.default_rng(time.time_ns())
    variants = [inputs._replace(pt=inputs.pt + np.float32(
        1e-6 * rng.uniform(0.5, 1.5) * (i + 1))) for i in range(repeats)]
    warm = [inputs._replace(pt=inputs.pt + np.float32(
        2e-6 * rng.uniform(0.5, 1.5) * (i + 1))) for i in range(min(WARM_CALLS, repeats))]
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for w in warm:
        acc = acc + slice_probe(fn(w), variant)
    if not np.isfinite(float(acc)):
        raise AssertionError(f"{variant}: the warm-up chain is not finite")
    del warm

    acc = torch.zeros((), dtype=torch.float32, device=device)
    if gpu:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for v in variants:
        acc = acc + slice_probe(fn(v), variant)
    total = float(acc)  # the chain's one read
    dt = (time.perf_counter() - t0) / repeats
    if not np.isfinite(total):
        raise AssertionError(f"{variant}: the timed chain is not finite")

    moved = nbytes(variants[0], fn(variants[0]))
    cols_per_s = ngptot / dt
    record = {
        "metric": f"{variant}_columns_per_second_{impl}_{platform}",
        "value": cols_per_s,
        "unit": "columns/s/chip",
        "vs_baseline": cols_per_s / BASELINE_COLS_PER_S,
        "ngptot": ngptot,
        "nlev": nlev,
        "platform": platform,
        "ms_per_call": dt * 1e3,
        "bytes_accessed_gb": moved / 1e9,
        "attained_gbps": moved / dt / 1e9,
    }
    del variants
    if tlad and os.environ.get("CLOUDSC2_BENCH_F32_CHECKS", "1") == "1":
        record["f32_verdicts"] = f32_verdicts(state, min(ngptot, 16384), device)
    record.update(_baseline(cols_per_s))
    return record


def f32_verdicts(state, ncol: int, device) -> dict:
    """The CLI's f32 verdicts through the TL and AD kernels at ``ncol``
    columns, with each tolerance's margin over the measured error; the
    tolerances sit 5-10x above the errors measured when they were set, so
    a margin under 4 is flagged (``bench.py:299-336``)."""
    import torch

    from .cli import measure_f32_verdicts

    inputs = state.device_inputs(ncol, dtype=torch.float32, device=device)
    fv = {k: (float(f"{v:.6e}") if isinstance(v, float) else v)
          for k, v in measure_f32_verdicts(state, inputs).items()}
    fv["ngptot"] = ncol
    fv["tl_parity_margin"] = round(
        fv["tl_parity_tol"] / max(fv["tl_parity_rel_err"], 1e-30), 1)
    fv["ad_identity_margin"] = round(
        fv["ad_identity_tol"] / max(fv["ad_identity_rel_err"], 1e-30), 1)
    fv["margin_ok"] = bool(fv["tl_parity_margin"] >= 4.0
                           and fv["ad_identity_margin"] >= 4.0)
    if not fv["margin_ok"]:
        print(f"bench: WARNING f32 verdict margin < 4x: {fv}", file=sys.stderr)
    return fv


def bench_chunked(variant: str, device, nlev, repeats: int) -> dict:
    """The ``chunked`` and ``chunked_tlad`` variants: ``run_chunked`` over
    more columns than the card holds."""
    import numpy as np
    import torch

    from . import dist
    from .drivers import chunk_columns, run_chunked, run_nl, run_tlad
    from .state import Cloudsc2State

    gpu = device.type == "cuda"
    platform = "gpu" if gpu else "cpu"
    inner = "tlad" if variant.endswith("tlad") else "nl"
    ngptot = int(os.environ.get("CLOUDSC2_BENCH_NGPTOT", 10485760 if gpu else 2048))
    chunk = int(os.environ.get("CLOUDSC2_BENCH_CHUNK",
                               327680 if gpu else min(327680, ngptot)))
    sublanes = None if gpu else 1
    nlev = nlev or (137 if gpu else 17)
    state = Cloudsc2State.synthetic(ngptot=100, nlev=nlev)
    mesh = (dist.column_mesh(device)
            if os.environ.get("CLOUDSC2_BENCH_MESH", "1") == "1" else None)
    ndev = 1 if mesh is None else mesh.size
    cards = [device] if mesh is None else mesh.lanes
    kw = dict(variant=inner, chunk=chunk, sublanes=sublanes, device=device,
              mesh=mesh)

    if gpu:
        torch.cuda.init()  # the cards' allocators, before their statistics
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    cols, s = run_chunked(state, ngptot, **kw)  # the warm pass
    if not np.isfinite(s):
        raise AssertionError(f"{variant}: the warm pass is not finite")
    t0 = time.perf_counter()
    for _ in range(repeats):
        cols, s = run_chunked(state, ngptot, **kw)
        if not np.isfinite(s):
            raise AssertionError(f"{variant}: a timed pass is not finite")
    dt = (time.perf_counter() - t0) / repeats
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards) if gpu else None

    # what one chunk's kernels read and write, counted on one chunk's tensors
    ccols = chunk_columns(state, chunk, variant=inner, sublanes=sublanes,
                          lanes=ndev)
    one = state.device_kernel_inputs(ccols, dtype=torch.float32, device=device,
                                     pqs=inner == "tlad")
    out = (run_tlad(one, state.params, lregcl=True) if inner == "tlad"
           else run_nl(one, state.params))
    streamed = nbytes(one, out) * (cols // ccols)
    del one, out

    cols_per_s = cols / dt
    record = {
        "metric": f"{inner}_columns_per_second_chunked_{platform}",
        # per card, so that vs_baseline stays per card over a mesh; the
        # mesh's rate rides along
        "value": cols_per_s / ndev,
        "unit": "columns/s/chip",
        "vs_baseline": cols_per_s / ndev / BASELINE_COLS_PER_S,
        "mesh_columns_per_second": cols_per_s,
        "ngptot": cols,
        "chunk": ccols,
        "nlev": nlev,
        "mesh_devices": ndev,
        "platform": platform,
        "ms_per_pass": dt * 1e3,
        "ms_per_chunk": dt * 1e3 * ccols / cols,
        "streamed_gb": streamed / 1e9,
        "peak_allocated_gb": None if peak is None else peak / 1e9,
        "device_memory_gb": (torch.cuda.get_device_properties(device)
                             .total_memory / 1e9 if gpu else None),
    }
    record.update(_baseline(cols_per_s / ndev))
    return record


def main(argv=None) -> dict:
    """Run the variant that ``CLOUDSC2_BENCH_VARIANT`` names, print its
    record as one JSON line and return it."""
    parser = argparse.ArgumentParser(
        prog="cloudsc2jax_torch.bench",
        description="columns per second of one variant on one card")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda times the kernels; cpu runs their plain "
                             "versions (for tests, not a measurement)")
    parser.add_argument("--nlev", type=int, default=None,
                        help="levels of the synthetic state (default 137; "
                             "the chunked variants on the CPU default to 17)")
    args = parser.parse_args(argv)
    variant = os.environ.get("CLOUDSC2_BENCH_VARIANT", "nl")
    if variant not in VARIANTS:
        raise SystemExit(f"CLOUDSC2_BENCH_VARIANT must be one of "
                         f"{', '.join(VARIANTS)}, not {variant!r}")
    repeats = int(os.environ.get("CLOUDSC2_BENCH_REPEATS", 20))

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: --device cuda, but no CUDA device is available")
    device = torch.device(args.device)
    if variant.startswith("chunked"):
        record = bench_chunked(variant, device, args.nlev, repeats)
    else:
        record = bench_unit(variant, device, args.nlev or 137, repeats)
    if device.type == "cuda":
        record.update(card())
    else:
        record.update(device_name=None, power_limit_w=None,
                      note="plain PyTorch versions on the CPU: not a number "
                           "of any card")
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
