"""Time the NL kernel and the forward-checkpoint kernel of any checkout, to
compare two commits on one card at the kernels themselves (``ab_unit.py``
times the whole ``run_nl`` and ``run_tlad`` calls, in which a few percent of
one kernel drown).

Run on a machine with one CUDA card, from the root of a checkout that holds
``tests/fixtures``::

    python3 cloudsc2jax_torch/probes/ab_nl_kernels.py <root of the checkout to time> <label>

Prints three readings each at 327,680 f32 columns, by CUDA events over 40
launches on distinct inputs.  Unpack the other commit with ``git archive``
into a gitignored directory and run parent, change, change, parent in one
go, on one card.
"""
import sys


def main() -> None:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch

    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    st = Cloudsc2State.load("tests/fixtures/input.npz")
    p = st.params

    def time_ms(fn, args_list, calls=40):
        for a in args_list:
            fn(*a)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / calls

    base = st.device_kernel_inputs(327680, dtype=torch.float32, device="cuda", pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base)) for s in (37, 71)]
    pairs = [(s, km.kernel_prelude(s, p)) for s in sets]
    for _ in range(3):
        print(label, "nl", round(time_ms(lambda i, q: km.launch_cloudsc2_nl(i, q, p), pairs), 4),
              "fwd_ckpt", round(time_ms(lambda i, q: km.launch_cloudsc2_fwd_ckpt(i, q, p), pairs), 4),
              flush=True)


if __name__ == "__main__":
    main()
