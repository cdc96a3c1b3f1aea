"""CUDA-gated tests of the port: the hand-written kernel on the card.

Marked ``cuda``; each test skips without a CUDA device.  The file imports
neither JAX nor ``conftest``, so on a machine with the card and without
JAX it runs on its own::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import pathlib

import pytest
import torch

from cloudsc2jax_torch import cli
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.state import Cloudsc2State

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_cuda_kernel_matches_plain_version(dtype, tol, ldrain1d):
    """The kernel against its plain version on the same card and inputs
    (the check of chip_smoke.py's phase 3), on a ragged column count."""
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(1000, dtype=dtype, device="cuda")
    launches = kmod.cloudsc2_nl.launches
    got = kmod.cloudsc2_nl(inputs, st.params, ldrain1d=ldrain1d)
    ref = kmod.cloudsc2_nl_reference(inputs, st.params, ldrain1d=ldrain1d)
    assert kmod.cloudsc2_nl.launches == launches + 1
    for name, a, b in zip(got._fields, got, ref):
        assert torch.isfinite(a).all(), name
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() / scale <= tol, name


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_operands():
    _need_cuda()
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = st.device_kernel_inputs(300, dtype=torch.float32, device="cuda")
    pre = kmod.kernel_prelude(inputs, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl(inputs._replace(pt=inputs.pt.T.contiguous().T),
                                pre, st.params)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl(inputs._replace(pq=inputs.pq.double()),
                                pre, st.params)
    with pytest.raises(TypeError):
        kmod.launch_cloudsc2_nl(
            type(inputs)(*(None if x is None else x.half() for x in inputs)),
            kmod.KernelPrelude(*(x.half() for x in pre)), st.params)


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["nl", "1", "4096", "128", "--dtype", "f32", "--threshold", "10000"],
    ["nl", "1", "4096", "128", "--dtype", "f64"],
])
def test_cuda_cli_validates_through_the_kernel(argv):
    _need_cuda()
    launches = kmod.cloudsc2_nl.launches
    assert cli.main(argv + ["--device", "cuda"]) == 0
    assert kmod.cloudsc2_nl.launches == launches + 1
