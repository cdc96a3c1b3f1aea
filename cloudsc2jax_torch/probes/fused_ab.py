"""Schedules of the TL+AD unit against each other, as medians over
processes: by default the fused unit against the two-kernel unit.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/fused_ab.py [processes] [root] [config ...]

Runs ``python -m cloudsc2jax_torch.kernel_ab <configs>`` (default ``two
fused fused two``; ``two enc encnp two`` for the encoded units) at 327,680
f32 columns in ``processes`` processes (default 3), one after another, with
the package of the checkout at ``root`` (default: this one; a ``git
archive`` of another commit unpacked into a gitignored directory times that
commit), and reads each process's summary line.  Prints every reading and,
per schedule, the median over processes of each process's mean of its
readings, with the card's name and power limit.  Processes, because
``run_tlad`` is bimodal across them (ROADMAP.md §3, fault 1).
"""
import json
import os
import pathlib
import statistics
import subprocess
import sys

CONFIGS = ("two", "fused", "fused", "two")


def main(argv) -> int:
    processes = int(argv[0]) if argv else 3
    root = pathlib.Path(argv[1] if len(argv) > 1 else ".").resolve()
    summary = medians(processes, root, tuple(argv[2:]) or CONFIGS)
    if summary is None:
        return 1
    print(json.dumps(summary))
    return 0


def medians(processes: int, root: pathlib.Path, configs) -> dict:
    """Run ``kernel_ab`` with ``configs`` in ``processes`` processes, print
    each process's readings as a JSON line, and return the summary (card,
    readings, median ms per config); None if a process failed."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    env = {**os.environ, "CLOUDSC2_AB_NGPTOT": "327680", "PYTHONPATH": str(root)}
    readings = {name: [] for name in dict.fromkeys(configs)}
    for n in range(processes):
        proc = subprocess.run(
            [sys.executable, "-m", "cloudsc2jax_torch.kernel_ab", *configs],
            capture_output=True, text=True, cwd=root, env=env, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return None
        summary = json.loads(proc.stdout.strip().splitlines()[-1])["configs"]
        for name, r in readings.items():
            r.append([v["ms"] for k, v in summary.items()
                      if k.split("#")[0] == name])
        print(json.dumps({"root": str(root), "process": n + 1,
                          **{k: v[-1] for k, v in readings.items()}}), flush=True)
    return {"card": card, "root": str(root), "processes": processes,
            "readings": readings,
            "median_ms": {name: statistics.median(statistics.mean(r) for r in rs)
                          for name, rs in readings.items()}}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
