"""The schedule of the fused TL+AD kernel (``csrc/cloudsc2_tlad_fused.cu``).

A block of that kernel holds ``tl_groups`` TL warpgroups and ``ad_groups``
AD warpgroups of 128 threads each.  Each role sets its own register budget
by ``setmaxnreg`` as it starts, so the TL body runs at the TL budget and the
AD body at the AD budget in one launch.  A TL warpgroup sweeps a tile of
128 columns and hands its checkpoints to an AD warpgroup through a ring of
``depth`` tile slots; the AD warpgroups of a ring take its tiles in turn.
:class:`Split` is that choice for one variant, :data:`PLANS` the shipped
choice for every variant (f32 / f64 x evaporation x ``lregcl``).

Plain Python on purpose: the CPU tests hold every shipped split to the
rules of :func:`check`, and ``kernels/build.py`` passes the same table to
nvcc as ``-D`` defines (:func:`defines`), from which the
kernel takes its compile-time constants and checks the same rules again
with ``static_assert``.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import re
from typing import Dict, Tuple

__all__ = ["FIELDS", "GROUP_THREADS", "PLANS", "SLOT_HEADER_BYTES", "Split", "TILE",
           "check", "define_name", "defines", "stash_slots"]

GROUP_THREADS = 128            # threads of a warpgroup
TILE = 128                     # columns of a tile: one per thread of a warpgroup
CHECKPOINTS = 3                # carry checkpoints per level and column
REGISTERS_PER_SM = 65_536
MAX_REGISTERS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1024
SHARED_PER_BLOCK = 232_448     # the 227 KB a block may opt into
SHARED_PER_SM = 233_472        # 228 KB, of which each block reserves 1 KB
RESERVED_SHARED_PER_BLOCK = 1024
NAMED_BARRIERS = 16            # barrier 0 is __syncthreads'
# a ring slot's header: the full and empty mbarriers and the tile index
SLOT_HEADER_BYTES = 24

_AD_HEADER = (pathlib.Path(__file__).resolve().parents[1] / "csrc"
              / "cloudsc2_ad_level.cuh")
_ITEMSIZE = {"float32": 4, "float64": 8}
Variant = Tuple[str, bool, bool]  # (dtype name, evap, lregcl)


@dataclasses.dataclass(frozen=True)
class Split:
    """Warpgroups per block by role, blocks per SM, each role's register
    budget (``setmaxnreg``) and the ring depth per TL warpgroup."""

    tl_groups: int
    ad_groups: int
    blocks_per_sm: int
    tl_registers: int
    ad_registers: int
    depth: int

    @property
    def threads(self) -> int:
        return GROUP_THREADS * (self.tl_groups + self.ad_groups)

    @property
    def launch_registers(self) -> int:
        """Registers per thread the block is launched with: what
        ``__launch_bounds__(threads, blocks_per_sm)`` leaves ptxas, in the
        allocation unit of 8."""
        cap = REGISTERS_PER_SM // (self.threads * self.blocks_per_sm)
        return min(MAX_REGISTERS_PER_THREAD, cap) // 8 * 8

    @property
    def consumers(self) -> int:
        """AD warpgroups per TL warpgroup's ring."""
        return self.ad_groups // self.tl_groups

    @property
    def role_registers(self) -> int:
        """Registers the roles hold once both have set their budgets."""
        return GROUP_THREADS * (self.tl_groups * self.tl_registers
                                + self.ad_groups * self.ad_registers)

    def warps_per_sm(self) -> Dict[str, int]:
        return {"tl": 4 * self.tl_groups * self.blocks_per_sm,
                "ad": 4 * self.ad_groups * self.blocks_per_sm}

    def shared_bytes(self, dtype: str, evap: bool, lregcl: bool) -> int:
        """Dynamic shared memory of a block: the AD warpgroups' parked
        slots (none for the TL warpgroups) and the ring headers."""
        stash = (self.ad_groups * GROUP_THREADS * stash_slots(evap, lregcl)
                 * _ITEMSIZE[dtype])
        return stash + self.tl_groups * self.depth * SLOT_HEADER_BYTES

    def blocks(self, ncol: int, sms: int) -> int:
        """Blocks of the persistent grid: as many as the card holds at once,
        or fewer where the columns have fewer tiles than rings."""
        tiles = -(-ncol // TILE)
        return max(1, min(self.blocks_per_sm * sms, -(-tiles // self.tl_groups)))

    def scratch_bytes(self, blocks: int, nlev: int, dtype: str) -> int:
        """The checkpoint ring in device memory: 3 * nlev * 128 values per
        tile slot, ``depth`` slots per TL warpgroup of every block."""
        return (blocks * self.tl_groups * self.depth * CHECKPOINTS * nlev * TILE
                * _ITEMSIZE[dtype])


@functools.lru_cache(maxsize=None)
def stash_slots(evap: bool, lregcl: bool) -> int:
    """Shared-memory slots per thread of the AD body ``Level<evap,
    lregcl>``, from the generated header's own comment."""
    flags = f"{str(evap).lower()}, {str(lregcl).lower()}"
    m = re.search(rf"lregcl: {flags} \(\d+ statements, live peak \d+, (\d+) shared "
                  r"slots", _AD_HEADER.read_text())
    if m is None:
        raise RuntimeError(f"no shared-slot count for Level<{flags}> in "
                           f"{_AD_HEADER.name}")
    return int(m.group(1))


def check(split: Split, variant: Variant) -> Split:
    """Raise ValueError naming the first rule ``split`` breaks for
    ``variant``; return it otherwise.  The rules: ``setmaxnreg`` takes a
    multiple of 8 in [24, 256] and lowers (TL) or raises (AD) the launch
    count; the roles' registers fit the block's pool (threads x launch
    registers) and the SM's 65,536; the AD warpgroups split evenly over the
    rings, each ring deep enough for its consumers (the mbarrier phases
    cannot alias then); a named barrier per TL warpgroup; the threads,
    the block's shared memory and the SM's."""
    dtype, evap, lregcl = variant
    s = split
    what = f"fused split {s} for {variant}"
    if s.tl_groups < 1 or s.ad_groups < 1 or s.blocks_per_sm < 1:
        raise ValueError(f"{what}: every count must be at least 1")
    if s.threads > MAX_THREADS_PER_BLOCK:
        raise ValueError(f"{what}: {s.threads} threads per block, more than "
                         f"{MAX_THREADS_PER_BLOCK}")
    if s.tl_groups + 1 > NAMED_BARRIERS:
        raise ValueError(f"{what}: one named barrier per TL warpgroup")
    if s.ad_groups % s.tl_groups:
        raise ValueError(f"{what}: {s.ad_groups} AD warpgroups do not split "
                         f"evenly over {s.tl_groups} rings")
    if s.depth < s.consumers:
        raise ValueError(f"{what}: a ring of depth {s.depth} is shallower than "
                         f"its {s.consumers} consumers")
    for role, regs in (("TL", s.tl_registers), ("AD", s.ad_registers)):
        if regs % 8 or not 24 <= regs <= 256:
            raise ValueError(f"{what}: the {role} budget {regs} is not a "
                             f"multiple of 8 in [24, 256]")
    launch = s.launch_registers
    if s.tl_registers > launch or s.ad_registers < launch:
        raise ValueError(f"{what}: setmaxnreg.dec must lower and .inc raise "
                         f"the launch count {launch} (TL {s.tl_registers}, "
                         f"AD {s.ad_registers})")
    pool = s.threads * launch
    if s.role_registers > pool:
        raise ValueError(f"{what}: the roles take {s.role_registers} registers, "
                         f"more than the block's pool of {pool}")
    if s.blocks_per_sm * pool > REGISTERS_PER_SM:
        raise ValueError(f"{what}: {s.blocks_per_sm} blocks of {pool} registers "
                         f"exceed the SM's {REGISTERS_PER_SM}")
    shared = s.shared_bytes(dtype, evap, lregcl)
    if shared > SHARED_PER_BLOCK:
        raise ValueError(f"{what}: {shared} B of shared memory per block, more "
                         f"than {SHARED_PER_BLOCK}")
    if s.blocks_per_sm * (shared + RESERVED_SHARED_PER_BLOCK) > SHARED_PER_SM:
        raise ValueError(f"{what}: {s.blocks_per_sm} blocks of {shared} B exceed "
                         f"the SM's {SHARED_PER_SM} B of shared memory")
    return split


# The shipped splits.  f32: three blocks of one TL and one AD warpgroup per
# SM, launched at 80 registers; the TL role drops to the TL kernel's 64 and
# the AD role rises to 96, the AD kernel's budget (12 + 12 warps per SM).
# f64, the validation path: one block of 1 + 1, the TL role at 200 and the
# AD role at 256 (its body takes 196-204 unbounded).  probes/fused_grid.py
# measures other splits of the f32 work unit's body.
_F32 = Split(tl_groups=1, ad_groups=1, blocks_per_sm=3, tl_registers=64,
             ad_registers=96, depth=2)
_F64 = Split(tl_groups=1, ad_groups=1, blocks_per_sm=1, tl_registers=200,
             ad_registers=256, depth=2)
PLANS: Dict[Variant, Split] = {
    (dtype, evap, lregcl): (_F32 if dtype == "float32" else _F64)
    for dtype in ("float32", "float64")
    for evap in (False, True)
    for lregcl in (False, True)
}


def define_name(variant: Variant) -> str:
    dtype, evap, lregcl = variant
    return (f"CLOUDSC2_FUSED_{'F32' if dtype == 'float32' else 'F64'}"
            f"_E{int(evap)}_R{int(lregcl)}")


# the -D define of each field of a Split, after the variant's prefix (nvcc
# splits a define's value at commas, so each field is a define of its own)
FIELDS = (("NT", "tl_groups"), ("NA", "ad_groups"), ("BLOCKS", "blocks_per_sm"),
          ("TL", "tl_registers"), ("AD", "ad_registers"), ("DEPTH", "depth"))


def defines(plans: Dict[Variant, Split] = PLANS) -> Tuple[str, ...]:
    """The nvcc ``-D`` defines of ``plans`` (every variant, each checked):
    ``CLOUDSC2_FUSED_F32_E0_R1_NT=1``, ``..._NA=1``, ``..._BLOCKS=3``,
    ``..._TL=64``, ``..._AD=96``, ``..._DEPTH=2`` and so on."""
    out = []
    for variant in sorted(PLANS):
        s = check(plans[variant], variant)
        out += [f"{define_name(variant)}_{suffix}={getattr(s, field)}"
                for suffix, field in FIELDS]
    return tuple(out)
