"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into a shared library that
:mod:`ctypes` loads (pointers come from ``Tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``).  The library goes to
``build/cloudsc2jax_torch/<hash>/`` under the checkout, keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  ``-Xptxas -v`` reports every kernel's registers and
spills; the report is kept beside the library (:func:`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List

__all__ = ["load_library", "ptxas_report", "nvcc_path", "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "cloudsc2jax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def _build_dir(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless this exact build exists, then load
    it (once per process).  Raises with nvcc's output if the build fails."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    out_dir = _build_dir(name)
    so = out_dir / f"lib{name}.so"
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} building "
                f"{name}.cu:\n{proc.stdout}{proc.stderr}"
            )
        (out_dir / f"{name}.ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBRARIES[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> List[dict]:
    """Registers and spills of every kernel entry in the built library,
    parsed from ``-Xptxas -v``: a list of ``{"entry", "registers",
    "stack_bytes", "spill_store_bytes", "spill_load_bytes"}``."""
    text = (_build_dir(name) / f"{name}.ptxas.txt").read_text()
    entries: List[dict] = []
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            entries.append({"entry": m.group(1)})
            continue
        if not entries:
            continue
        # the first properties after an entry line are the entry's own
        m = _SPILL.search(line)
        if m and "stack_bytes" not in entries[-1]:
            entries[-1].update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        m = _REGS.search(line)
        if m and "registers" not in entries[-1]:
            entries[-1]["registers"] = int(m.group(1))
    return entries
