"""The TPU kernels' other schedules of the TL+AD unit against the shipped
ones, as medians over processes: the 17-stream adjoint convention against
the in-place scatter on both contracts, and C levels a step against one.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/schedule_ab.py [processes] [root]

Runs ``python -m cloudsc2jax_torch.kernel_ab`` with ``noprim xscatnp two
xscat chunk:2 chunk:3 chunk:4 xscat two xscatnp noprim`` (each pair in turns
within a process, the order reversed in its second half) at 327,680 f32
columns in ``processes`` processes (default 3), as ``fused_ab.py`` does,
and prints each process's readings, then one JSON line: per config the
median over processes of each process's mean, and per pair the ratio of
the schedule's median to the shipped one's (``xscat / two``, ``xscatnp /
noprim``, ``chunk:C / two``), with the card's name and power limit.
Processes, because ``run_tlad`` is bimodal across them (ROADMAP.md §3,
fault 1).
"""
import json
import pathlib
import sys

from fused_ab import medians

CONFIGS = ("noprim", "xscatnp", "two", "xscat", "chunk:2", "chunk:3", "chunk:4",
           "xscat", "two", "xscatnp", "noprim")
PAIRS = (("xscat", "two"), ("xscatnp", "noprim"), ("chunk:2", "two"),
         ("chunk:3", "two"), ("chunk:4", "two"))


def main(argv) -> int:
    processes = int(argv[0]) if argv else 3
    root = pathlib.Path(argv[1] if len(argv) > 1 else ".").resolve()
    summary = medians(processes, root, CONFIGS)
    if summary is None:
        return 1
    ms = summary["median_ms"]
    summary["ratio"] = {f"{new} / {old}": ms[new] / ms[old] for new, old in PAIRS}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
