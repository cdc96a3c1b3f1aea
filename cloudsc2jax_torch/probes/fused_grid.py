"""Time the fused TL+AD kernel under several block sizes and blocks per SM,
to pick its launch shape by measurement.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/fused_grid.py [threads:min_blocks ...]

For each ``threads:min_blocks`` (default: a spread around 128:4) the probe
rebuilds ``csrc/cloudsc2_tlad_fused.cu`` with ``-DCLOUDSC2_FUSED_THREADS``
and ``-DCLOUDSC2_FUSED_MIN_BLOCKS_F32`` (the source keeps the two macros
for this probe alone), reads ptxas' registers and spills of the f32 kernel
the work unit runs (evap off, lregcl on), asks the occupancy calculator how
many blocks one SM holds, and times the kernel at 327,680 f32 columns by
CUDA events over distinct inputs, at that many blocks per SM and at each
smaller count.  The package sizes the grid by the occupancy calculator and
has no option for less, so for the smaller counts the probe replaces
``experiments.fused_slots`` while it times.  One JSON line per row.
"""
import json
import sys


def main() -> None:
    sys.path.insert(0, ".")
    import torch

    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    configs = sys.argv[1:] or ["128:4", "128:3", "128:2", "64:8", "256:1", "256:2"]
    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    ncol = 327680
    base = st.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
    pres = [kernel_prelude(s, p) for s in sets]
    nlev = base.pt.shape[0]

    def time_ms(slots, calls=9):
        ex.fused_slots = lambda *args, **kwargs: slots
        try:
            for i, pre in zip(sets, pres):
                ex.launch_cloudsc2_tlad_fused(i, pre, p)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for c in range(calls):
                ex.launch_cloudsc2_tlad_fused(sets[c % 3], pres[c % 3], p)
            e.record()
            torch.cuda.synchronize()
        finally:
            ex.fused_slots = fused_slots
        return s.elapsed_time(e) / calls

    fused_slots = ex.fused_slots
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flags = build.NVCC_FLAGS
    for cfg in configs:
        threads, min_blocks = (int(x) for x in cfg.split(":"))
        build.NVCC_FLAGS = flags + (f"-DCLOUDSC2_FUSED_THREADS={threads}",
                                    f"-DCLOUDSC2_FUSED_MIN_BLOCKS_F32={min_blocks}")
        build._LIBRARIES.pop(("cloudsc2_tlad_fused", (), ()), None)
        full = fused_slots(base, p)  # builds and binds this variant
        entry = next(e for e in build.ptxas_report("cloudsc2_tlad_fused")
                     if "IfLb0ELb1E" in e["entry"])
        per_sm = full // (sms * threads)
        for b in range(per_sm, 0, -1):
            slots = sms * b * threads
            print(json.dumps({
                "threads": threads, "min_blocks": min_blocks,
                "registers": entry["registers"],
                "spill_store_bytes": entry["spill_store_bytes"],
                "blocks_per_sm": b, "occupancy_blocks_per_sm": per_sm,
                "warps_per_sm": b * threads // 32, "slots": slots,
                "scratch_mb": 3 * nlev * slots * 4 / 1e6,
                "batches": ncol / slots, "ms": time_ms(slots)}), flush=True)
    build.NVCC_FLAGS = flags


if __name__ == "__main__":
    main()
