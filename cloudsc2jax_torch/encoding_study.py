"""Input-stream storage-encoding study: what a 2-byte storage of the input
streams costs in accuracy.

Port of the JAX package's ``tools/encoding_study.py``; the accuracy half of
the experiment whose throughput half is the encoded NL sweep
(:func:`cloudsc2jax_torch.kernels.experiments.cloudsc2_nl_encoded`)::

    python -m cloudsc2jax_torch.encoding_study [--device cpu]

It round-trips every field of the 100-column fixture's standard-contract
inputs through a candidate 2-byte encoding, runs the exact f64 truth path
(:func:`cloudsc2jax_torch.physics.cloudsc2.cloudsc2`) on the decoded state,
and reports each output field's relative error ``sum|a-b| / sum|b|`` against
the unquantised run, to be read against three budgets:

* the f32 working-precision path's own error against the f64 goldens
  (~1.6e-5),
* the f32 validation budget (1e4 x eps32 ~ 1.19e-3),
* the reference's 10 x eps64 golden criterion (2.2e-15), which any storage
  below f32 abandons.

Encodings:

``bf16``  raw bfloat16 storage (8 significant bits, ~0.4% relative)
``f16``   raw IEEE float16 storage (11 significant bits, ~0.05% relative;
          it cannot hold pressure)
``i16``   per field and PER LEVEL affine int16: offset the midrange and scale
          the halfrange over 32767 across the stored columns, so values
          become 16-bit anomalies from a level-dependent reference profile.
          This is what :func:`~.kernels.experiments.encode_blocked_inputs`
          stores.

The quantisation runs on the host in numpy and PyTorch; the four truth-path
runs run on ``--device`` (a card unless ``cpu`` is asked for).  Prints a JSON
table and returns it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

__all__ = ["BUDGETS", "SCHEMES", "main", "quantize", "study"]

FIXTURE = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "input.npz"
SCHEMES = ("bf16", "f16", "i16")
BUDGETS = {
    "f32_path_vs_f64_golden": 1.6e-5,
    "onchip_budget_1e4_eps32": 1.19e-3,
    "reference_10eps64": 2.2e-15,
}


def quantize(name: str, x, scheme: str) -> np.ndarray:
    """``x`` (``(ncol, nlev)``, any float array) stored under ``scheme`` and
    read back, in f64.  ``name`` is the field's, for symmetry with the JAX
    tool; no scheme depends on it."""
    x = np.asarray(x, np.float64)
    if scheme == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16).to(torch.float64).numpy()
    if scheme == "f16":
        with np.errstate(over="ignore"):
            return x.astype(np.float16).astype(np.float64)
    if scheme == "i16":
        # affine per trailing (level) index over the columns
        lo = x.min(axis=0)
        hi = x.max(axis=0)
        off = 0.5 * (hi + lo)
        scale = np.maximum((hi - lo) / 65534.0, 1e-300)
        q = np.clip(np.rint((x - off) / scale), -32767, 32767)
        return q * scale + off
    raise ValueError(scheme)


def study(device="cuda", fixture=FIXTURE) -> dict:
    """The table: ``{"budgets": ..., "encodings": {scheme:
    {"max_field_relerr", "per_field"}}}``."""
    from .physics.cloudsc2 import Cloudsc2Inputs, cloudsc2
    from .state import Cloudsc2State

    state = Cloudsc2State.load(fixture)
    host = state.device_inputs(dtype=torch.float64, device="cpu")  # (ncol, nlev)
    host = {n: x.contiguous().numpy() for n, x in host._asdict().items()}

    def run(arrays):
        inputs = Cloudsc2Inputs(**{
            n: torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for n, x in arrays.items()})
        out = cloudsc2(inputs, state.params)
        return {k: v.cpu().numpy() for k, v in out._asdict().items()}

    base = run(host)
    results = {}
    for scheme in SCHEMES:
        out = run({n: quantize(n, x, scheme) for n, x in host.items()})
        errs = {}
        for k, a in out.items():
            b = base[k]
            # the reference's validation relative error: sum|a-b|/sum|b|
            # (validate_mod.F90:271-284, normal regime)
            denom = np.abs(b).sum()
            errs[k] = float(np.abs(a - b).sum() / denom) if denom > 0 else 0.0
        results[scheme] = {
            "max_field_relerr": max(errs.values()),
            "per_field": {k: f"{v:.2e}" for k, v in errs.items()},
        }
    return {"budgets": dict(BUDGETS), "encodings": results}


def main(argv=None, device=None) -> dict:
    """Run the study, print its table as JSON and return it.  ``device``
    overrides ``--device``."""
    parser = argparse.ArgumentParser(
        prog="cloudsc2jax_torch.encoding_study",
        description="accuracy of 2-byte storage encodings of the input streams")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the f64 truth path runs")
    args = parser.parse_args(argv)
    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    table = study(device)
    print(json.dumps(table, indent=1), flush=True)
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
