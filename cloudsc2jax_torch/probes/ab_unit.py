"""Time ``run_nl`` and ``run_tlad`` (stream contract) of any checkout, to
compare two commits on one card.

Run on a machine with one CUDA card, from the root of a checkout that
holds ``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/ab_unit.py <root of the checkout to time> <label>

Prints two readings each at 327,680 f32 columns, by CUDA events over
distinct inputs.  Unpack the other commit with ``git archive`` into a
gitignored directory and run parent, change, change, parent in one session.
"""
import sys


def main() -> None:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch
    from cloudsc2jax_torch.drivers import run_nl, run_tlad
    from cloudsc2jax_torch.state import Cloudsc2State
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    st = Cloudsc2State.load("tests/fixtures/input.npz"); p = st.params
    def time_ms(fn, args_list, calls):
        for a in args_list: fn(*a)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(calls): fn(*args_list[i % len(args_list)])
        e.record(); torch.cuda.synchronize()
        return s.elapsed_time(e) / calls
    base = st.device_kernel_inputs(327680, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
    nl_sets = [s._replace(pqs=None) for s in sets]
    for rep in range(2):
        print(label, "run_nl", round(time_ms(lambda i: run_nl(i, p), [(s,) for s in nl_sets], 30), 4),
              "run_tlad", round(time_ms(lambda i: run_tlad(i, p), [(s,) for s in sets], 10), 4), flush=True)


if __name__ == "__main__":
    main()
