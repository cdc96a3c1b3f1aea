"""A/B harness for the TL+AD work unit's schedules on one card.

Port of the JAX package's ``tools/kernel_ab.py``.  Runs the work unit under
each named schedule on one set of inputs and prints one timing line per
schedule, then one JSON summary line::

    python -m cloudsc2jax_torch.kernel_ab two noprim fused enc encnp two
    python -m cloudsc2jax_torch.kernel_ab noprim xscatnp two xscat chunk:2 chunk:4

Configs:

- ``two``    the production two-kernel unit: the TL sweep with checkpoint
             and primal streams, then the reverse sweep from the
             checkpoints (``run_tlad(backend="streams")``).
- ``noprim`` the same without the 8 primal output streams (the reference
             AD driver's contract).
- ``fused``  the single-launch unit with the checkpoints in a scratch sized
             by the grid (``kernels.experiments.cloudsc2_tlad_fused``).
- ``enc``    the two-kernel unit over int16-encoded level streams; each
             variant is encoded OUTSIDE the timed region, the premise being
             that the data lives encoded in device memory.
- ``encnp``  both diets: encoded, and no primal streams.
- ``xscat``  ``two`` with the reverse sweep under the 17-stream adjoint
             convention (``kernels.schedules.cloudsc2_ad_xscat``): 17
             shifted-view streams a level, d_plu and d_paph assembled by
             PyTorch passes after it.  A/B against ``two``.
- ``xscatnp`` the same without the primal streams; A/B against ``noprim``.
- ``chunk:<C>`` ``two`` with both sweeps C levels a step
             (``kernels.schedules.cloudsc2_tl_chunked`` and
             ``cloudsc2_ad_chunked``, C one of the built 2, 3, 4; the reverse
             sweep under the 17-stream convention, its only one).

A config named twice is run twice and keyed ``name#2``: a drift control.
Compare configs of ONE invocation only; two invocations may land on cards
with different power limits.

``CLOUDSC2_AB_NGPTOT`` (default 163840) and ``CLOUDSC2_AB_REPS`` (default 8)
set the columns and the distinct input variants; variant ``i`` bumps ``pt``
by ``1e-6 * u * (i + 1)`` with ``u`` drawn anew in every run.  Each config's
buffers are freed before the next one starts.

Timing is by CUDA events around the REPS launches, after a warm-up over
the first variants, with one synchronise at the end.  The JAX harness
chains a scalar of every output into an accumulator to defeat XLA's
dead-code elimination and asynchronous dispatch; eager PyTorch on a CUDA
stream runs every kernel it is given, in order, so the events alone bound
the work.  ``--device cpu`` runs the plain versions under the host's clock
(for the tests; its times say nothing about a card).

Refused, with a message: a ``:<S>`` sublanes suffix (a TPU layout
parameter with no meaning here), so also the JAX harness's three-part
``chunk:<S>:<C>``, and a ``chunk`` with no level count or one not built.  A
config that fails to build, launch or run raises, and the run exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIGS = ("two", "noprim", "fused", "enc", "encnp", "xscat", "xscatnp", "chunk")
DEFAULT_CONFIGS = ("two", "noprim", "fused")


def _check_config(cfg: str) -> int:
    """Raise ``ValueError`` for a config this harness does not run; returns
    its levels a step (1 but for ``chunk:<C>``)."""
    from .kernels.schedules import CHUNK_LEVELS

    kind, *args = cfg.split(":")
    if kind not in CONFIGS:
        raise ValueError(f"{cfg}: unknown config, choose from {', '.join(CONFIGS)}")
    if len(args) > (kind == "chunk"):
        hint = "chunk:<C>" if kind == "chunk" else repr(kind)
        raise ValueError(f"{cfg}: a :<S> sublanes suffix is a TPU layout "
                         f"parameter and has no meaning here; write {hint}")
    if kind != "chunk":
        return 1
    built = ", ".join(map(str, CHUNK_LEVELS))
    if not args or not args[0].isdigit() or int(args[0]) not in CHUNK_LEVELS:
        raise ValueError(f"{cfg}: write chunk:<C> with C levels a step, one of "
                         f"the built {built}")
    return int(args[0])


def _step_fn(cfg: str, params):
    """The work of one config on one variant: (outputs | None, tangents,
    input adjoints)."""
    from .drivers import DSCALE, run_tlad
    from .kernels.cloudsc2_kernel import kernel_prelude
    from .kernels.experiments import (
        cloudsc2_ad_encoded,
        cloudsc2_tl_encoded,
        cloudsc2_tlad_fused,
    )
    from .kernels.schedules import (
        cloudsc2_ad_chunked,
        cloudsc2_ad_xscat,
        cloudsc2_tl_chunked,
    )
    from .kernels.tlad_kernel import cloudsc2_tl

    kind, chunk = cfg.partition(":")[0], _check_config(cfg)
    if kind in ("xscat", "xscatnp"):
        # the two-kernel unit of run_tlad with the reverse sweep under the
        # 17-stream convention
        def unit(v):
            pre = kernel_prelude(v, params)
            out, dout, ckpts = cloudsc2_tl(v, params, dscale=DSCALE, lregcl=True,
                                           write_primal=kind == "xscat", pre=pre)
            adj = cloudsc2_ad_xscat(v, dout, ckpts, params, lregcl=True, pre=pre)
            return out, dout, adj
        return unit
    if kind == "chunk":
        # the same with both sweeps C levels a step
        def chunked(v):
            pre = kernel_prelude(v, params)
            out, dout, ckpts = cloudsc2_tl_chunked(v, params, dscale=DSCALE,
                                                   chunk_levels=chunk, lregcl=True,
                                                   pre=pre)
            adj = cloudsc2_ad_chunked(v, dout, ckpts, params, chunk_levels=chunk,
                                      lregcl=True, pre=pre)
            return out, dout, adj
        return chunked
    if kind == "fused":
        return lambda v: cloudsc2_tlad_fused(v, params, lregcl=True)
    if kind in ("enc", "encnp"):
        def work(v):
            out, dout, ckpts = cloudsc2_tl_encoded(
                v, params, dscale=DSCALE, lregcl=True, write_primal=kind == "enc")
            adj = cloudsc2_ad_encoded(v, dout, ckpts, params, lregcl=True,
                                      fold_seeds=True)
            return out, dout, adj
        return work
    return lambda v: run_tlad(v, params, lregcl=True,
                              write_primal=kind == "two")


def _time_ms(step, variants, device) -> float:
    """Mean ms per unit over the variants; on a card after a warm-up over
    the first four."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for v in variants:
            step(v)
        return (time.perf_counter() - t0) / len(variants) * 1e3
    for v in variants[:4]:
        step(v)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for v in variants:
        step(v)
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / len(variants)


def _card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(", ")
    return {"device": name, "power_limit": limit}


def main(argv=None, device=None) -> dict:
    """Run the configs in ``argv`` and return the summary that the last
    line prints.  ``device`` overrides ``--device``."""
    parser = argparse.ArgumentParser(
        prog="cloudsc2jax_torch.kernel_ab",
        description="time the TL+AD work unit under each of its schedules")
    parser.add_argument("configs", nargs="*", default=list(DEFAULT_CONFIGS))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda times the kernels; cpu runs their plain "
                             "versions")
    parser.add_argument("--nlev", type=int, default=137,
                        help="levels of the synthetic state (137 is the "
                             "model's; fewer is for quick checks)")
    args = parser.parse_args(argv)
    for cfg in args.configs:
        _check_config(cfg)

    import numpy as np
    import torch

    from .kernels.experiments import encode_blocked_inputs
    from .state import Cloudsc2State

    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    ngptot = int(os.environ.get("CLOUDSC2_AB_NGPTOT", 163840))
    reps = int(os.environ.get("CLOUDSC2_AB_REPS", 8))
    state = Cloudsc2State.synthetic(ngptot=100, nlev=args.nlev)
    rng = np.random.default_rng(time.time_ns())
    results = {}
    for cfg in args.configs:
        key, n = cfg, 2
        while key in results:  # repeated configs are drift controls
            key = f"{cfg}#{n}"
            n += 1
        inputs = state.device_kernel_inputs(ngptot, dtype=torch.float32,
                                            device=device, pqs=True)
        variants = []
        for i in range(reps):
            v = inputs._replace(pt=inputs.pt + np.float32(
                1e-6 * rng.uniform(0.5, 1.5) * (i + 1)))
            if cfg in ("enc", "encnp"):
                # the bump lands in the table's offset row by re-encoding
                v = encode_blocked_inputs(v, state.params, fuse_satur=False)
            variants.append(v)
        ms = _time_ms(_step_fn(cfg, state.params), variants, device)
        print(f"{cfg}: {ms:.4f} ms  {ngptot / ms / 1e3:.4f} M cols/s", flush=True)
        results[key] = {"ms": ms, "mcols_per_s": ngptot / ms / 1e3}
        # free this config's buffers before the next one allocates its own
        inputs = variants = v = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"platform": "gpu" if device.type == "cuda" else "cpu",
               **(_card() if device.type == "cuda" else {}),
               "ngptot": ngptot, "nlev": args.nlev, "reps": reps,
               "configs": results}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
