"""Where the truth path's TL+AD unit keeps its memory on the card.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/truth_memory.py

On the fixture's columns expanded to 16,384, 8,192, 4,096 and 2,048 f64
columns (137 levels), prints one JSON line per stage with its wall seconds
and its peak of allocated memory above what was held before it: the forward
sweep ``cloudsc2()`` alone, ``torch.func.jvp`` of it, ``torch.func.vjp``
seeded with the tangent without and with the level checkpoint
(``remat_level``), and the whole ``drivers._truth_unit`` both ways.  Then one
block of 4,096 of the 16,384 columns through the checkpointed unit in four
layouts: the strided rows of the batch's transposed levels-major views (a
block sliced from the batch without ``drivers._block``), the block made
levels-major-dense (``_block``, what ``map_columns`` hands ``fn``), the
rows of a row-major ``(ncol, nlev)`` batch (contiguous, but a view of it),
and those rows copied into a tensor of their own.
Each line names the card and its power limit.  Exits 2 without a card.
"""
import json
import pathlib
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("truth_memory: no CUDA device", file=sys.stderr)
        return 2
    from cloudsc2jax_torch.drivers import DSCALE, _block, _truth_unit
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs, cloudsc2
    from cloudsc2jax_torch.state import Cloudsc2State

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    root = pathlib.Path(__file__).resolve().parents[2]
    st = Cloudsc2State.load(root / "tests" / "fixtures" / "input.npz")
    params = st.params

    def peak(stage, ncol, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        print(json.dumps({
            "stage": stage, "ncol": ncol, "s": time.perf_counter() - t0,
            "peak_above_held_mb": (torch.cuda.max_memory_allocated() - held) / 1e6,
            "held_mb": held / 1e6, "card": card}), flush=True)
        return result

    unit = partial(_truth_unit, params=params, lregcl=True, ldrain1d=False)
    unit(st.device_inputs(128, dtype=torch.float64, device="cuda"), remat=True)
    for ncol in (16384, 8192, 4096, 2048):
        x = st.device_inputs(ncol, dtype=torch.float64, device="cuda")
        d = Cloudsc2Inputs(*(DSCALE * v for v in x))
        f = partial(cloudsc2, params=params, lregcl=True)
        peak("forward", ncol, lambda: f(x))
        _, dout = peak("jvp", ncol, lambda: torch.func.jvp(f, (x,), (d,)))
        for remat in (False, True):
            def vjp():
                _, fn = torch.func.vjp(partial(f, remat_level=remat), x)
                return fn(dout)

            peak(f"vjp remat={remat}", ncol, vjp)
            peak(f"unit remat={remat}", ncol, lambda: unit(x, remat=remat))
        del x, d, dout

    x = st.device_inputs(16384, dtype=torch.float64, device="cuda")
    rows = Cloudsc2Inputs(*(v.contiguous() for v in x))
    blocks = {
        "strided rows of the batch's views": Cloudsc2Inputs(*(v[:4096] for v in x)),
        "levels-major dense (_block)": Cloudsc2Inputs(
            *(_block(v, start=0, stop=4096, nproma=4096) for v in x)),
        "rows of a row-major batch (a view)": Cloudsc2Inputs(*(v[:4096] for v in rows)),
        "row-major contiguous": Cloudsc2Inputs(*(v[:4096].contiguous() for v in x)),
    }
    for layout, b in blocks.items():
        peak(f"unit remat=True, one block, {layout}", 4096, lambda: unit(b, remat=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
