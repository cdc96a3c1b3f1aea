"""Time the resident NL kernel under several rings, to pick its default block
and depth by measurement.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/resident_rings.py [tile:depth ...]

For each ``tile:depth`` (columns to a block, levels staged ahead; default a
spread from 128:1 to every level resident at 26:137) the probe times the
kernel at 327,680 f32 columns by CUDA events over distinct inputs, with the
exact NL kernel and the forward-checkpoint kernel before and after as the
drift control.  One JSON line per row.
"""
import json
import sys


def main() -> None:
    sys.path.insert(0, ".")
    import torch

    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    rings = sys.argv[1:] or ["128:1", "128:2", "256:2", "64:4", "128:4", "256:4",
                             "32:8", "64:8", "128:8", "128:16", "26:137"]
    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    base = st.device_kernel_inputs(327680, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
    pairs = [(s, km.kernel_prelude(s, p)) for s in sets]
    nlev = base.pt.shape[0]

    def time_ms(fn, calls):
        for a in pairs:
            fn(*a)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for c in range(calls):
            fn(*pairs[c % len(pairs)])
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / calls

    def controls():
        return {"exact_nl_ms": time_ms(lambda i, q: km.launch_cloudsc2_nl(i, q, p), 30),
                "fwd_ckpt_ms": time_ms(lambda i, q: km.launch_cloudsc2_fwd_ckpt(i, q, p), 30)}

    print(json.dumps(controls()), flush=True)
    for ring in rings:
        tile, depth = (int(x) for x in ring.split(":"))
        _, depth, ring_bytes = km.resident_ring(nlev, torch.float32, tile, depth)
        ms = time_ms(lambda i, q: km.launch_cloudsc2_nl_resident(
            i, q, p, tile=tile, depth=depth), 30 if depth < nlev else 3)
        print(json.dumps({"tile": tile, "depth": depth, "ring_bytes": ring_bytes,
                          "ms": ms}), flush=True)
    print(json.dumps(controls()), flush=True)


if __name__ == "__main__":
    main()
