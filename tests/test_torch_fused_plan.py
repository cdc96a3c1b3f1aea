"""The fused TL+AD kernel's split (``cloudsc2jax_torch/kernels/fused_plan.py``).

Plain Python, so it runs here: every shipped split obeys the rules of
``setmaxnreg`` and fits the SM (registers, shared memory, threads), the
scratch is sized by the grid and not by the columns, a split that breaks a
rule raises, and the build hands the same table to nvcc.  The CUDA-gated
tests in ``test_torch_cuda.py`` hold the kernel built from it.
"""

import pathlib
import re

import pytest

from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import fused_plan as fp

VARIANTS = sorted(fp.PLANS)
SOURCE = (pathlib.Path(fp.__file__).resolve().parents[1] / "csrc"
          / "cloudsc2_tlad_fused.cu")
ITEMSIZE = {"float32": 4, "float64": 8}


@pytest.mark.parametrize("variant", VARIANTS)
def test_shipped_split_obeys_setmaxnreg_and_fits_the_sm(variant):
    dtype, evap, lregcl = variant
    s = fp.check(fp.PLANS[variant], variant)
    for regs in (s.tl_registers, s.ad_registers):
        assert regs % 8 == 0 and 24 <= regs <= 256
    launch = s.launch_registers
    assert launch % 8 == 0 and s.tl_registers <= launch <= s.ad_registers
    pool = s.threads * launch
    assert s.role_registers <= pool
    assert s.blocks_per_sm * pool <= 65_536
    assert s.threads <= 1024 and s.ad_groups % s.tl_groups == 0
    assert s.depth >= s.consumers
    shared = s.shared_bytes(dtype, evap, lregcl)
    assert shared <= 227 * 1024
    assert s.blocks_per_sm * (shared + 1024) <= 228 * 1024
    # the parked slots belong to the AD warpgroups alone
    stash = s.ad_groups * 128 * fp.stash_slots(evap, lregcl) * ITEMSIZE[dtype]
    assert shared == stash + s.tl_groups * s.depth * fp.SLOT_HEADER_BYTES


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ncol,nlev", [(100, 137), (5001, 137), (327_680, 137),
                                       (10_000_000, 60)])
def test_scratch_is_sized_by_the_grid(variant, ncol, nlev):
    """blocks x NT x D slots of 3 x nlev x 128 values, whatever ncol."""
    dtype = variant[0]
    s = fp.PLANS[variant]
    blocks = s.blocks(ncol, 132)
    tiles = -(-ncol // 128)
    assert 1 <= blocks <= s.blocks_per_sm * 132
    assert blocks * s.tl_groups >= min(tiles, s.blocks_per_sm * 132 * s.tl_groups)
    assert s.scratch_bytes(blocks, nlev, dtype) == (
        blocks * s.tl_groups * s.depth * 3 * nlev * 128 * ITEMSIZE[dtype])
    if ncol >= 327_680:
        assert blocks == s.blocks_per_sm * 132


def test_the_f32_work_unit_split_is_the_two_bodies_budgets():
    """The f32 work unit's body: TL at the TL kernel's 64 registers, AD at
    the AD kernel's 96, each role at least 12 warps per SM."""
    s = fp.PLANS["float32", False, True]
    assert (s.tl_registers, s.ad_registers) == (64, 96)
    assert min(s.warps_per_sm().values()) >= 12


BROKEN = {
    "a budget not a multiple of 8": fp.Split(1, 1, 3, 60, 100, 2),
    "a budget above 256": fp.Split(1, 1, 1, 200, 264, 2),
    "a budget below 24": fp.Split(1, 1, 3, 16, 96, 2),
    "roles beyond the pool": fp.Split(1, 1, 3, 72, 96, 2),
    "an inc below the launch count": fp.Split(1, 3, 1, 64, 96, 3),
    "uneven AD warpgroups per ring": fp.Split(2, 3, 1, 64, 112, 2),
    "a ring shallower than its consumers": fp.Split(1, 4, 1, 64, 104, 3),
    "too many threads": fp.Split(1, 8, 1, 24, 64, 8),
    "too much shared memory per SM": fp.Split(1, 2, 2, 48, 96, 2),
    "too much shared memory per block": fp.Split(1, 4, 1, 64, 104, 4),
}


@pytest.mark.parametrize("rule", sorted(BROKEN))
def test_a_split_that_breaks_a_rule_raises(rule):
    with pytest.raises(ValueError, match="fused split"):
        fp.check(BROKEN[rule], ("float32", True, True))


def test_defines_carry_every_variant_and_the_build_uses_them():
    """A -D define per field and variant, read back to the split (no comma in
    a value: nvcc splits values at commas); the source refuses to build
    without them; a build that names no defines of its own gets them, a
    probe's build.variant replaces them."""
    defines = fp.defines()
    assert len(defines) == len(fp.PLANS) * len(fp.FIELDS) == 48
    assert not any("," in d for d in defines)
    values = dict(d.split("=") for d in defines)
    for variant, split in fp.PLANS.items():
        got = {field: int(values[f"{fp.define_name(variant)}_{suffix}"])
               for suffix, field in fp.FIELDS}
        assert fp.Split(**got) == split
    text = SOURCE.read_text()
    for variant in fp.PLANS:
        assert re.search(rf"!defined\({fp.define_name(variant)}_NT\)", text)
    for suffix, _ in fp.FIELDS:
        assert f"P##_{suffix}" in text
    assert build._key("cloudsc2_tlad_fused") == ("cloudsc2_tlad_fused", defines, ())
    assert build._key("cloudsc2_ad") == ("cloudsc2_ad", (), ())
    probe = fp.defines({**fp.PLANS, ("float32", False, True): fp.Split(1, 4, 1, 64, 104, 4)})
    assert probe != defines
    with build.variant("cloudsc2_tlad_fused", probe):
        assert build._key("cloudsc2_tlad_fused")[1] == probe
    assert build._key("cloudsc2_tlad_fused")[1] == defines


def test_the_kernel_splits_roles_without_a_block_barrier():
    """The source's schedule: setmaxnreg per role, mbarrier handoff, a
    per-launch tile counter zeroed on the stream, and no barrier 0 after
    the roles split."""
    text = SOURCE.read_text()
    assert "setmaxnreg.dec.sync.aligned.u32" in text
    assert "setmaxnreg.inc.sync.aligned.u32" in text
    assert "mbarrier.try_wait.parity" in text and "atomicAdd(next_tile" in text
    assert "cudaMemsetAsync(next_tile" in text
    body = text[text.index("cloudsc2_tlad_fused_kernel(const"):]
    after_split = body[body.index("const int group = __shfl_sync"):
                       body.index("// The variant's split as the library was built")]
    assert "__syncthreads" not in after_split and "bar.sync 0" not in after_split
    assert "CLOUDSC2_FUSED_THREADS" not in text and "slots +=" not in text
