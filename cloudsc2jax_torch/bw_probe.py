"""Measure the device-memory streaming bandwidth a card attains, plainly
and at the access shape of the physics kernels.

Port of the JAX package's ``tools/bw_probe.py``.  Prints one JSON line::

    python -m cloudsc2jax_torch.bw_probe                       # plain stream
    CLOUDSC2_BW_PROBE_WINDOWS=15x8 python -m cloudsc2jax_torch.bw_probe

Plain streaming mode (no ``CLOUDSC2_BW_PROBE_WINDOWS``): ``out = a + s*b``
over two f32 arrays of ``CLOUDSC2_BW_PROBE_MB`` (default 256) MiB each, two
reads and one write per element, the simplest 12-bytes-per-element stream.
It is one PyTorch expression (``torch.add(a, b, alpha=s)``), as it is one XLA
expression in the JAX tool, not a kernel of this package.

Window-matched mode (``CLOUDSC2_BW_PROBE_WINDOWS=RxW``): the hand-written
kernel ``csrc/bw_probe.cu``, which has the access shape of the physics
kernels on the card (one thread per column, a loop over ``nlev`` levels, per
level R coalesced row reads and W row writes of levels-major ``(nlev, ncol)``
f32 arrays) and a trivial body, ``out[j] = in[j % R]*s + in[(j+1) % R]``.  So
the NL (15x8), forward-checkpoint (16x11), TL (16x19), streamed TL (32x16)
and reverse-adjoint (27x16, ``CLOUDSC2_BW_PROBE_REV=1``) mixes can be judged
against a ceiling that pays the same access pattern at the same traffic, not
against a flat copy.  R and W are compile-time constants of the kernel, so
each mix is a build of its own (a few seconds, cached under ``build/``).

Compute-weighted mode (``CLOUDSC2_BW_PROBE_COMPUTE=T,F``, window mode only):
adds T ``tanh`` and F flops (F/2 - T fused multiply-adds) per element and
level as one serially dependent chain, mixed into every output at 1e-20, so
the ceiling pays the physics kernels' arithmetic density too.  The JAX
tool's calibration: the NL body is about ``10,292``, the TL sweep (primal and
tangent) ``20,584``, the reverse adjoint (recompute and transpose)
``30,876``.

Environment, as in the JAX tool: ``CLOUDSC2_BW_PROBE_WINDOWS``, ``_NLEV``
(137), ``_NB`` (20) and ``_SUBLANES`` (64), whose product times 128 is the
number of columns (the TPU tool's blocks of ``(S, 128)`` windows; here only
the product matters), ``_REV``, ``_REPEATS`` (20), ``_COMPUTE``, ``_MB``.
``CLOUDSC2_BW_PROBE_INTERPRET`` has no meaning here (there is no interpret
mode for a CUDA kernel) and is ignored with a note on standard error;
``--device cpu`` runs the plain versions under the host's clock (for the
tests; its times say nothing about a card).

Before it times a mix on the card the probe checks the kernel against the
plain version on the same arrays, forward and reversed: every (level,
column) element carries its own data, so a wrong index shows (``rtol``
1e-6).  Timing is by CUDA events around ``repeats`` launches with distinct
``s``, after a warm-up of 8, with one synchronise.  The record has the JAX
record's fields, ``"platform": "gpu"``, the card's name and power limit, and
the traffic and time unrounded (``traffic_bytes``, ``ms_per_call``,
``attained_gbps``) and the self-check's worst absolute difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["KERNEL_MIXES", "launch_window_stream", "main", "probe_defines",
           "stream_probe", "window_probe", "window_stream", "window_stream_reference"]

WARMUP = 8

# The window mixes of the port's kernels (chip_smoke.py phase 16, the
# battery of onchip_evidence.py): label, reads, writes, reversed, and the
# tanh,flops per element of the compute-weighted run (None: plain only), as
# the JAX tool calibrates them for the NL, TL and AD bodies
KERNEL_MIXES = (
    ("nl", 15, 8, False, (10, 292)),
    ("fwd", 16, 11, False, (10, 292)),
    ("tl", 16, 19, False, (20, 584)),
    ("din", 32, 16, False, (20, 584)),
    ("ad", 27, 16, True, (30, 876)),
    ("res", 16, 8, False, None),
    ("fused", 16, 32, False, None),
)


def probe_defines(reads: int, writes: int, compute: Tuple[int, int] = (0, 0)):
    """The ``-D`` defines of ``csrc/bw_probe.cu`` for one mix."""
    return (f"BW_PROBE_R={reads}", f"BW_PROBE_W={writes}",
            f"BW_PROBE_TANH={compute[0]}", f"BW_PROBE_FLOPS={compute[1]}")


def window_stream_reference(
    arrs: Sequence[torch.Tensor], s: float, writes: int, *,
    compute: Tuple[int, int] = (0, 0),
) -> List[torch.Tensor]:
    """The plain PyTorch version of the probe's kernel, on any device: the
    body of ``tools/bw_probe.py:78-94`` on whole arrays.  The level order
    does not show in the result."""
    reads = len(arrs)
    n_trans, n_flops = compute
    work = None
    if n_trans or n_flops:
        work = arrs[0]
        for t in range(n_trans):
            work = torch.tanh(work + arrs[t % reads] * 1e-3)
        for f in range(max(n_flops - 2 * n_trans, 0) // 2):
            work = work * 1.0000001 + arrs[f % reads] * 1e-6
        work = work * 1e-20
    outs = []
    for j in range(writes):
        out = arrs[j % reads] * s + arrs[(j + 1) % reads]
        outs.append(out if work is None else out + work)
    return outs


def launch_window_stream(
    arrs: Sequence[torch.Tensor], s: float, writes: int, *, rev: bool = False,
    compute: Tuple[int, int] = (0, 0), out: Optional[List[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Launch the probe's kernel on CUDA tensors, on the current stream.

    ``arrs`` are R contiguous ``(nlev, ncol)`` f32 tensors on one card;
    ``out``, if given, W such tensors to write into (else they are
    allocated).  Builds the kernel for this mix at first use, and raises if
    the launch is refused.  Counts each launch in
    ``window_stream.launches``."""
    from .kernels.cloudsc2_kernel import bind_library

    like = arrs[0]
    if like.device.type != "cuda":
        raise ValueError(f"launch_window_stream needs CUDA tensors, got {like.device}")
    if like.dim() != 2:
        raise ValueError(f"expected (nlev, ncol) arrays, got {tuple(like.shape)}")
    if writes < 1:
        raise ValueError(f"the probe writes at least one array, got {writes}")
    if out is None:
        out = [torch.empty_like(like) for _ in range(writes)]
    if len(out) != writes:
        raise ValueError(f"expected {writes} output arrays, got {len(out)}")
    for name, x in [(f"in[{j}]", x) for j, x in enumerate(arrs)] + [
            (f"out[{j}]", x) for j, x in enumerate(out)]:
        if (x.device != like.device or x.dtype != torch.float32
                or x.shape != like.shape):
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on {x.device}, "
                             f"expected float32 {tuple(like.shape)} on {like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    reads = len(arrs)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib = bind_library(
        "bw_probe", {"bw_probe_abi": (reads, writes, *compute)},
        {"bw_probe_f32": [ptrs, ptrs, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p]},
        defines=probe_defines(reads, writes, compute))
    nlev, ncol = like.shape
    in_ptrs = (ctypes.c_void_p * reads)(*(x.data_ptr() for x in arrs))
    out_ptrs = (ctypes.c_void_p * writes)(*(x.data_ptr() for x in out))
    with torch.cuda.device(like.device):
        err = lib.bw_probe_f32(in_ptrs, out_ptrs, float(s), ncol, nlev, int(rev),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bw_probe kernel launch failed: cudaError_t {err}")
    window_stream.launches += 1
    return out


def window_stream(
    arrs: Sequence[torch.Tensor], s: float, writes: int, *, rev: bool = False,
    compute: Tuple[int, int] = (0, 0), out: Optional[List[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """One pass of the window-matched probe: W arrays ``in[j % R]*s +
    in[(j+1) % R] + work`` from the R arrays ``arrs``, the levels visited
    forward or, with ``rev``, backwards.

    CUDA tensors run the hand-written kernel (:func:`launch_window_stream`);
    CPU tensors run the plain version :func:`window_stream_reference`; any
    other device raises."""
    kind = arrs[0].device.type
    if kind == "cpu":
        return window_stream_reference(arrs, s, writes, compute=compute)
    if kind != "cuda":
        raise ValueError(f"window_stream runs on cuda or cpu tensors, not "
                         f"{arrs[0].device}")
    return launch_window_stream(arrs, s, writes, rev=rev, compute=compute, out=out)


window_stream.launches = 0


def _card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(", ")
    return {"device": name, "power_limit": limit}


def _time_s(step, repeats: int, device: torch.device) -> float:
    """Mean seconds per call of ``step(i)`` over ``repeats`` calls; on a card
    by CUDA events after a warm-up, with one synchronise."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(repeats):
            step(1e-6 * (i + 1))
        return (time.perf_counter() - t0) / repeats
    for i in range(WARMUP):
        step(1e-7 * (i + 1))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for i in range(repeats):
        step(1e-6 * (i + 1))
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) * 1e-3 / repeats


def _platform(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", **_card()}
    return {"platform": "cpu"}


def window_probe(device="cuda") -> dict:
    """Time the window-matched probe for the mix in the environment and
    return its record.  On a card the kernel is first held against the
    plain version, forward and reversed."""
    device = torch.device(device)
    reads, writes = (int(x) for x in
                     os.environ["CLOUDSC2_BW_PROBE_WINDOWS"].lower().split("x"))
    nlev = int(os.environ.get("CLOUDSC2_BW_PROBE_NLEV", 137))
    sublanes = int(os.environ.get("CLOUDSC2_BW_PROBE_SUBLANES", 64))
    nb = int(os.environ.get("CLOUDSC2_BW_PROBE_NB", 20))
    rev = os.environ.get("CLOUDSC2_BW_PROBE_REV", "0") == "1"
    repeats = int(os.environ.get("CLOUDSC2_BW_PROBE_REPEATS", 20))
    compute = tuple(int(x) for x in
                    os.environ.get("CLOUDSC2_BW_PROBE_COMPUTE", "0,0").split(","))
    if len(compute) != 2:
        raise ValueError("CLOUDSC2_BW_PROBE_COMPUTE takes T,F")
    ncol = nb * sublanes * 128

    gen = torch.Generator(device=device).manual_seed(0)
    arrs = [torch.rand((nlev, ncol), generator=gen, device=device,
                       dtype=torch.float32) for _ in range(reads)]
    out = [torch.empty_like(arrs[0]) for _ in range(writes)]
    check = {}
    if device.type == "cuda":
        s0 = 2.0
        worst = 0.0
        want = window_stream_reference(arrs, s0, writes, compute=compute)
        for flag in (False, True):
            for o in out:
                o.zero_()
            got = window_stream(arrs, s0, writes, rev=flag, compute=compute, out=out)
            for j, (a, b) in enumerate(zip(got, want)):
                if not torch.allclose(a, b, rtol=1e-6, atol=0.0):
                    raise AssertionError(
                        f"window probe {reads}x{writes} rev={flag}: output {j} "
                        f"differs from the plain version by "
                        f"{(a - b).abs().max().item():.3e}")
                worst = max(worst, (a - b).abs().max().item())
        check = {"self_check_max_abs_err": worst}
        del want

    dt = _time_s(lambda s: window_stream(arrs, s, writes, rev=rev,
                                         compute=compute, out=out),
                 repeats, device)
    traffic = (reads + writes) * nlev * ncol * 4
    return {
        **_platform(device),
        "mode": "windows",
        "windows": f"{reads}x{writes}",
        "compute_per_element": {"transcendentals": compute[0],
                                "flops": compute[1]},
        "rev": rev,
        "nb": nb,
        "sublanes": sublanes,
        "nlev": nlev,
        "columns": ncol,
        "traffic_gb_per_call": round(traffic / 1e9, 3),
        "traffic_bytes": traffic,
        "ms_per_call": dt * 1e3,
        "attained_gbps": traffic / dt / 1e9,
        **check,
    }


def stream_probe(device="cuda") -> dict:
    """Time the plain stream ``a + s*b`` and return its record."""
    device = torch.device(device)
    mb = int(os.environ.get("CLOUDSC2_BW_PROBE_MB", 256))  # per array
    repeats = int(os.environ.get("CLOUDSC2_BW_PROBE_REPEATS", 20))
    n = mb * 1024 * 1024 // 4
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    b = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    out = torch.empty_like(a)
    dt = _time_s(lambda s: torch.add(a, b, alpha=s, out=out), repeats, device)
    if not bool(torch.isfinite(out[:2]).all() and torch.isfinite(out[-2:]).all()):
        raise AssertionError("the plain stream wrote non-finite values")
    traffic = 3 * n * 4
    return {
        **_platform(device),
        "array_mb": mb,
        "traffic_gb_per_call": round(traffic / 1e9, 3),
        "traffic_bytes": traffic,
        "ms_per_call": dt * 1e3,
        "attained_gbps": traffic / dt / 1e9,
    }


def main(argv=None, device=None) -> dict:
    """Run the probe the environment asks for, print its record as one JSON
    line and return it.  ``device`` overrides ``--device``."""
    parser = argparse.ArgumentParser(
        prog="cloudsc2jax_torch.bw_probe",
        description="streaming bandwidth, plain or at the physics kernels' "
                    "access shape (set CLOUDSC2_BW_PROBE_WINDOWS=RxW)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda times the card; cpu runs the plain versions")
    args = parser.parse_args(argv)
    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if os.environ.get("CLOUDSC2_BW_PROBE_INTERPRET"):
        print("bw_probe: CLOUDSC2_BW_PROBE_INTERPRET is ignored: a CUDA kernel "
              "has no interpret mode (--device cpu runs the plain version)",
              file=sys.stderr)
    if os.environ.get("CLOUDSC2_BW_PROBE_WINDOWS"):
        record = window_probe(device)
    else:
        record = stream_probe(device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
