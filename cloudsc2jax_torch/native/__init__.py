"""The host runtime shim, C++ bound with ctypes.

Port of :mod:`cloudsc2jax.native`: ``hostinfo.cpp`` (the reference's
``mycpu.c`` sched_getcpu wrapper, a monotonic clock, the energy counters of
ec_pmon_mod.F90 and a cyclic column expansion) is built with ``g++`` at its
first use into ``build/cloudsc2jax_torch/native/<source hash>/`` under the
checkout, not into the package directory as the JAX package builds it.
Where no compiler or no library is to be had, every entry point keeps the
JAX package's fallback: ``-1``, the host's monotonic clock, or ``False``
(the caller tiles with numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np

__all__ = ["HostInfo", "hostinfo"]

SOURCE = pathlib.Path(__file__).resolve().parent / "hostinfo.cpp"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build"
              / "cloudsc2jax_torch" / "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libcloudsc2host.so"


def build() -> pathlib.Path:
    """Build the library unless it is there; returns its path.  The
    compiler writes a temporary file that is renamed into place, so
    processes that build at once each load a whole library.  Raises
    ``OSError`` or ``subprocess.CalledProcessError`` where ``g++`` fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class HostInfo:
    """The shim's four functions; the library is built and loaded at the
    first call, once."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False

    def _load(self) -> Optional[ctypes.CDLL]:
        if self._tried:
            return self._lib
        self._tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.cloudsc2_sched_getcpu.argtypes = []
        lib.cloudsc2_sched_getcpu.restype = ctypes.c_int
        lib.cloudsc2_monotonic_ns.argtypes = []
        lib.cloudsc2_monotonic_ns.restype = ctypes.c_int64
        lib.cloudsc2_energy_uj.argtypes = []
        lib.cloudsc2_energy_uj.restype = ctypes.c_int64
        lib.cloudsc2_expand_f64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64]
        lib.cloudsc2_expand_f64.restype = None
        self._lib = lib
        return lib

    @property
    def available(self) -> bool:
        """Whether the library was built and loaded."""
        return self._load() is not None

    def sched_getcpu(self) -> int:
        """The core this thread runs on; -1 without the library."""
        lib = self._load()
        return int(lib.cloudsc2_sched_getcpu()) if lib else -1

    def monotonic_ns(self) -> int:
        lib = self._load()
        return int(lib.cloudsc2_monotonic_ns()) if lib else time.monotonic_ns()

    def energy_uj(self) -> int:
        """Cray's pm_counters, then RAPL, in microjoules; -1 where neither
        can be read or without the library."""
        lib = self._load()
        return int(lib.cloudsc2_energy_uj()) if lib else -1

    def expand_f64(self, src, dst: np.ndarray) -> bool:
        """Cyclic column expansion ``dst[c] = src[c % n]``, both row-major
        ``(cols, depth…)`` float64.  Returns False without the library (the
        caller then tiles with numpy)."""
        lib = self._load()
        if lib is None:
            return False
        src = np.ascontiguousarray(src, dtype=np.float64)
        # the shapes guard the C memcpy sweep: a mismatch would write out
        # of bounds, not raise
        if not (dst.flags["C_CONTIGUOUS"] and dst.dtype == np.float64):
            raise ValueError("expand_f64: dst must be C-contiguous float64")
        if src.shape[0] == 0 or dst.shape[1:] != src.shape[1:]:
            raise ValueError(f"expand_f64: shapes {src.shape} -> {dst.shape}")
        depth = int(np.prod(src.shape[1:], dtype=np.int64))
        lib.cloudsc2_expand_f64(src.ctypes.data, src.shape[0], dst.ctypes.data,
                                dst.shape[0], depth)
        return True


hostinfo = HostInfo()
