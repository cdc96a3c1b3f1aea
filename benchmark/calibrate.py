"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.calibrate --config cloudsc2-tlad-f32 \\
        --cells tlad.noprim tlad.standard --seeds 1-48 --control-seeds 1-4

In one process: for every seed, one input set at the cells' full size,
one call of each cell's entry after a warm-up, every column compared with
the reference as a run compares it (the lower readings); then the control (the reference one
precision below, ``adapters/control_bf16.py``) in the system's place on its
seeds, compared the same way (the upper readings).  The reference of all
seeds runs as one batch of their stored columns.  Prints one JSON line per
cell and seed, then a summary line per cell.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import compare, data, fields
from .harness import ROOT, load_cell
from .reference import physics


def _seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _reference(config, stored, ceta, c):
    """The reference over every set's stored columns in one batch."""
    x = {k: torch.cat([s[k].double().T for s in stored]) for k in stored[0]}
    if config["unit"] == "nl":
        return (physics.nl(x, ceta, c, ldrain1d=config["ldrain1d"]),)
    return physics.tlad(x, ceta, c, dscale=config["dscale"], lregcl=config["lregcl"],
                        ldrain1d=config["ldrain1d"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-48 or 3,9,2147483648")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--ngptot", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cells = [load_cell(ROOT, name) for name in args.cells]
    config = cells[0][2]
    if any(cell[2]["name"] != args.config for cell in cells):
        raise SystemExit("every cell must be of the one configuration")
    ncol = args.ngptot or config["ngptot"]
    config = {**config, "ngptot": ncol}
    dtype = data.DTYPES[config["dtype"]]
    c = physics.consts(config["ptsphy"], config["levapls2"])
    nlon = config["stored_columns"]
    port = importlib.import_module(f"benchmark.adapters.{config['adapter']}")
    control = importlib.import_module("benchmark.adapters.control_bf16")

    def stored_of(seeds):
        return [data.make_sets(s, 1, nlon=nlon, nlev=config["klev"], c=c, dtype=dtype,
                               pqs=config["unit"] != "nl")[0] for s in seeds]

    def readings(seeds, stored, adapter, ref, tag):
        res = {}
        for (_, cell, _, traffic) in cells:
            names = fields.expected(config["unit"], traffic["contract"],
                                    traffic.get("write_primal", True))
            refs = fields.reference_fields(ref, names)
            params = adapter.params(c, ceta, config)
            call = adapter.entry(params, config, traffic)
            rows = []
            for i, (seed, s) in enumerate(zip(seeds, stored)):
                x = adapter.inputs(data.tile(s, ncol, dev), config, traffic)
                if i == 0 and adapter is port:
                    call(x)  # the first call builds or loads the kernels
                out = adapter.outputs(call(x), config, traffic)
                r = compare.call_readings(
                    out, {k: v[i * nlon:(i + 1) * nlon] for k, v in refs.items()},
                    torch.arange(ncol), config["tolerance"])
                del out, x
                rows.append(r)
                print(json.dumps({"cell": cell["name"], "reading": tag, "seed": seed, **r}),
                      flush=True)
            res[cell["name"]] = rows
        return res

    t = time.perf_counter()
    seeds = _seeds(args.seeds)
    stored = stored_of(seeds)
    ceta = data.ceta(stored[0])
    ref = _reference(config, stored, ceta, c)
    print(f"reference of {len(seeds)} seeds: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    lower = readings(seeds, stored, port, ref, "program")
    upper = {}
    if args.control_seeds:
        cseeds = _seeds(args.control_seeds)
        cstored = stored_of(cseeds)
        upper = readings(cseeds, cstored, control, _reference(config, cstored, ceta, c),
                         "control")
    for name, rows in lower.items():
        summary = {"cell": name, "seeds": len(rows), "lower": compare.worst(rows)}
        if name in upper:
            summary["upper"] = {k: min(r[k] for r in upper[name]) for k in rows[0]}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
