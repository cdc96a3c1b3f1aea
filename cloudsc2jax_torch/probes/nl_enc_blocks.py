"""Time the encoded NL kernel under several register budgets, to pick its
``__launch_bounds__`` by measurement.

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/nl_enc_blocks.py [min_blocks ...]

For each ``min_blocks`` (blocks of 128 threads per SM that the register
budget must allow; default 1 4 6 8 10) the probe copies ``csrc/`` to
``build/nl_enc_blocks/<min_blocks>/``, sets ``kMinBlocks`` in the copy of
``cloudsc2_nl_enc.cu`` and builds that, reads ptxas' registers and spills of
the f32 kernels the timing runs (evap off, pqs computed, int16 and bfloat16
payload), and times the kernel at 327,680 f32 columns by CUDA events over
distinct inputs for the default encoding, ``keep_f32=("pq",)``, the bfloat16
payload and the all-f32 control, with the exact NL kernel before and after
as the drift control.  One JSON line per row.
"""
import json
import pathlib
import re
import shutil
import sys


def main() -> None:
    sys.path.insert(0, ".")
    import torch

    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        kernel_prelude,
        launch_cloudsc2_nl,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    budgets = [int(x) for x in sys.argv[1:]] or [1, 4, 6, 8, 10]
    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params
    base = st.device_kernel_inputs(327680, dtype=torch.float32, device="cuda")
    sets = [base] + [Cloudsc2Inputs(*(None if x is None else x.roll(s, dims=1)
                                      for x in base)) for s in (37, 71)]
    pres = [kernel_prelude(s, p) for s in sets]
    variants = {
        "default": {},
        "pq": dict(keep_f32=("pq",)),
        "bf16": dict(payload_dtype=torch.bfloat16),
        "all_f32": dict(keep_f32=ex.ENCODED_STREAMS),
    }
    encs = {label: [ex.encode_blocked_inputs(s, p, **kw) for s in sets]
            for label, kw in variants.items()}

    def time_ms(fn, args_list, calls=30):
        for a in args_list:
            fn(*a)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for c in range(calls):
            fn(*args_list[c % len(args_list)])
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / calls

    def exact():
        return time_ms(lambda i, q: launch_cloudsc2_nl(i, q, p),
                       list(zip(sets, pres)))

    csrc = build.CSRC
    print(json.dumps({"exact_nl_ms": exact()}), flush=True)
    for budget in budgets:
        copy = pathlib.Path("build") / "nl_enc_blocks" / str(budget)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(csrc, copy)
        source = copy / "cloudsc2_nl_enc.cu"
        text, n = re.subn(r"kMinBlocks = \d+;", f"kMinBlocks = {budget};",
                          source.read_text())
        if n != 1:
            raise AssertionError("cloudsc2_nl_enc.cu no longer sets kMinBlocks")
        source.write_text(text)
        build.CSRC = copy.resolve()
        build._LIBRARIES.pop(("cloudsc2_nl_enc", (), ()), None)
        ms = {label: time_ms(lambda e: ex.launch_cloudsc2_nl_encoded(e, p),
                             [(e,) for e in es])
              for label, es in encs.items()}
        regs = {("bf16" if "ELb0ELb1EE" in e["entry"] else "int16"):
                (e["registers"], e["spill_store_bytes"])
                for e in build.ptxas_report("cloudsc2_nl_enc")
                if "ILb0ELb0E" in e["entry"]}
        print(json.dumps({"min_blocks": budget,
                          "registers_spill_store_bytes": regs, "ms": ms}),
              flush=True)
    build.CSRC = csrc
    print(json.dumps({"exact_nl_ms": exact()}), flush=True)


if __name__ == "__main__":
    main()
