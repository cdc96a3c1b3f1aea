"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into a shared library that
:mod:`ctypes` loads (pointers come from ``Tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``).  The library goes to
``build/cloudsc2jax_torch/<hash>/`` under the checkout, keyed by a hash of
the sources, the flags, the ``-D`` defines, the library's extra flags and
the compiler's ``nvcc --version``, so an edited source or a new toolkit is
rebuilt and an unchanged build is loaded as it is.  ``-Xptxas -v`` reports
every kernel's registers and spills; the report is kept beside the library
(:func:`ptxas_report`).

A source whose shapes or budgets are compile-time constants
(``csrc/bw_probe.cu``, the register budgets of the TL and AD sweeps) is built once per set of defines: wherever a function here takes a
library's name it also takes ``(name, defines)`` or ``(name, defines,
flags)``, with ``defines`` a tuple of ``"KEY=value"`` strings and ``flags``
a tuple of extra nvcc flags (``-fmad=false``, ``-I<dir>``), and each such
build is a library of its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple, Union

__all__ = ["NVCC_FLAGS", "VARIANTS", "load_libraries", "load_library",
           "nvcc_path", "nvcc_version", "ptxas_report", "variant"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "cloudsc2jax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Spec = Union[str, Tuple[str, Sequence[str]],
             Tuple[str, Sequence[str], Sequence[str]]]
Key = Tuple[str, Tuple[str, ...], Tuple[str, ...]]
_LIBRARIES: Dict[Key, ctypes.CDLL] = {}
_NVCC_VERSION: List[str] = []
# per library, the -D defines and extra nvcc flags of every build of it that
# names none itself (the register budgets of probes/tlad_budget.py,
# -fmad=false for the TL parity check)
VARIANTS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}


@contextlib.contextmanager
def variant(name: str, defines: Sequence[str] = (), flags: Sequence[str] = ()):
    """Within the block, the builds and loads of ``name`` that name no
    defines or flags of their own (the wrappers' launches among them) use
    ``defines`` and the extra nvcc ``flags`` (``-fmad=false``, ``-I<dir>``):
    a library of its own, beside the default build."""
    before = VARIANTS.get(name)
    VARIANTS[name] = (tuple(defines), tuple(flags))
    try:
        yield
    finally:
        if before is None:
            VARIANTS.pop(name)
        else:
            VARIANTS[name] = before


def _key(spec: Spec) -> Key:
    if isinstance(spec, str):
        spec = (spec, ())
    name, defines, *flags = spec
    flags = tuple(flags[0]) if flags else ()
    if not defines and not flags:
        defines, flags = VARIANTS.get(name, ((), ()))
    return name, tuple(defines), flags


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


def nvcc_version() -> str:
    """The text of ``nvcc --version``, read once per process (empty where
    no compiler is found: nothing can be built there)."""
    if not _NVCC_VERSION:
        try:
            nvcc = nvcc_path()
        except RuntimeError:
            _NVCC_VERSION.append("")
        else:
            _NVCC_VERSION.append(subprocess.run(
                [nvcc, "--version"], capture_output=True, text=True,
                check=True).stdout)
    return _NVCC_VERSION[0]


def _command(name: str, defines: Sequence[str], flags: Sequence[str]) -> List[str]:
    """nvcc's arguments for a build, without the compiler and the output."""
    return [*NVCC_FLAGS, *flags, *(f"-D{d}" for d in defines),
            str(CSRC / f"{name}.cu")]


def _build_dir(name: str, defines: Sequence[str] = (),
               flags: Sequence[str] = ()) -> pathlib.Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *flags, *(f"-D{d}" for d in defines)]).encode())
    h.update(nvcc_version().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def load_library(name: str, defines: Sequence[str] = (),
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with ``-D`` for each of ``defines`` and
    the extra nvcc ``flags`` unless this exact build exists, then load it
    (once per process).  Raises with nvcc's output if the build fails."""
    return load_libraries([(name, defines, flags)])[0]


def load_libraries(specs: Sequence[Spec]) -> List[ctypes.CDLL]:
    """:func:`load_library` for several sources (names, or ``(name,
    defines)`` pairs), their nvcc runs started together so the builds
    overlap."""
    keys = [_key(spec) for spec in specs]
    running = []
    for key in dict.fromkeys(keys):
        if key in _LIBRARIES:  # loaded: no hashing on the launch path
            continue
        name, defines, flags = key
        out_dir = _build_dir(name, defines, flags)
        if (out_dir / f"lib{name}.so").is_file():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), "-o", str(tmp), *_command(name, defines, flags)]
        running.append((name, out_dir, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out_dir, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode} "
                          f"building {name}.cu ({out_dir.name}):\n{log}")
            continue
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    for key in keys:
        if key not in _LIBRARIES:
            _LIBRARIES[key] = ctypes.CDLL(
                str(_build_dir(*key) / f"lib{key[0]}.so"))
    return [_LIBRARIES[key] for key in keys]


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str, defines: Sequence[str] = (),
                 flags: Sequence[str] = ()) -> List[dict]:
    """Registers and spills of every kernel entry in the built library,
    parsed from ``-Xptxas -v``: a list of ``{"entry", "registers",
    "stack_bytes", "spill_store_bytes", "spill_load_bytes"}``."""
    text = (_build_dir(*_key((name, defines, flags))) / f"{name}.ptxas.txt").read_text()
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
