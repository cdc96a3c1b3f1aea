"""Where a pass of ``run_chunked`` spends its time on the card.

Run on a machine with one CUDA card, from the root of a checkout::

    python3 cloudsc2jax_torch/probes/chunked_breakdown.py [chunks]

For ``nl`` and ``tlad`` (the bench's ``chunked`` variants: the synthetic
state, 137 levels, chunks of 327,680 f32 columns, ``chunks`` of them,
default 10) prints one JSON line each with:

* ``pass_ms``: one pass by CUDA events, after a warm pass;
* ``parts_ms``: each part of a chunk alone by CUDA events over the chunks'
  own offsets: the generation (``tile_stored_columns``), the unit
  (``run_nl`` or ``run_tlad`` on generated inputs) and the checksum;
* ``profile``: device time per group of kernels (the port's, PyTorch's
  reductions, the rest) over one profiled pass (``torch.profiler``), each
  group's share of the pass's wall time, and the device's idle share;

with the card's name and power limit.
"""
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def _ms(fn, args_list) -> float:
    import torch

    fn(*args_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(args_list)


def _group(name: str) -> str:
    """The port's kernels, PyTorch's reductions (the checksum, the
    tropopause max), and every other PyTorch kernel (the generation's
    gather, the prelude's elementwise passes)."""
    if "cloudsc2_" in name:
        return "kernels"
    if "reduce" in name.lower():
        return "reductions"
    return "other"


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cloudsc2jax_torch.drivers import checksum, run_chunked, run_nl, run_tlad
    from cloudsc2jax_torch.state import Cloudsc2State, tile_stored_columns

    chunks = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    chunk = 327_680
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
    for variant in ("nl", "tlad"):
        tlad = variant == "tlad"

        def unit(inputs):
            return (run_tlad(inputs, st.params) if tlad
                    else run_nl(inputs, st.params))

        kw = dict(variant=variant, chunk=chunk)
        run_chunked(st, chunks * chunk, **kw)
        pass_ms = _ms(lambda: run_chunked(st, chunks * chunk, **kw), [()] * 3)

        base = st.stored_inputs(torch.float32, "cuda", pqs=tlad)
        offsets = [(i * chunk,) for i in range(chunks)]
        gen_ms = _ms(lambda o: tile_stored_columns(base, chunk, o), offsets)
        inputs = tile_stored_columns(base, chunk, 0)
        unit_ms = _ms(unit, [(inputs,)] * chunks)
        out = unit(inputs)
        sum_ms = _ms(checksum, [(out,)] * chunks)
        del inputs, out

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_chunked(st, chunks * chunk, **kw)
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops: their kernels are counted on their own
            g = _group(e.key)
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        busy = sum(groups.values())
        print(json.dumps({
            "variant": variant, "chunks": chunks, "chunk": chunk,
            "pass_ms": pass_ms, "ms_per_chunk": pass_ms / chunks,
            "parts_ms": {"generation": gen_ms, "unit": unit_ms, "checksum": sum_ms},
            "profile": {"wall_ms": wall_ms, "device_ms": groups,
                        "share_of_wall": {g: v / wall_ms for g, v in groups.items()},
                        "idle_share": max(0.0, 1.0 - busy / wall_ms)},
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
