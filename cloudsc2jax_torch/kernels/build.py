"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into a shared library that
:mod:`ctypes` loads.  :func:`bind` checks a library's argument layout
against its wrapper's and declares its entries, once per library and
process; :func:`launch` calls an entry with tensors as pointers (from
``Tensor.data_ptr()``) on the current stream
(``torch.cuda.current_stream().cuda_stream``): the one way Python reaches a
library of ``csrc/``.  :func:`occupancy` reads, through a library's
occupancy entry, what the kernel instance a launch runs costs an SM: the
one reader of the NL, TL and AD sweeps' counters.  The library goes to
``build/cloudsc2jax_torch/<hash>/`` under the checkout, keyed by a hash of
the sources, the flags, the ``-D`` defines, the library's extra flags and
the compiler's ``nvcc --version``, so an edited source or a new toolkit is
rebuilt and an unchanged build is loaded as it is.  ``-Xptxas -v`` reports
every kernel's registers and spills; the report is kept beside the library
(:func:`ptxas_report`).

A source whose shapes or budgets are compile-time constants
(``csrc/bw_probe.cu``, the register budgets of the TL and AD sweeps, the
fused kernel's split) is built once per set of defines: wherever a function here takes a
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
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import torch

__all__ = ["NO_FMA", "NVCC_FLAGS", "OCCUPANCY", "SHIPPED_FLAGS", "VARIANTS", "bind",
           "launch", "load_libraries", "load_library", "library_digest", "loop_census",
           "nvcc_path", "nvcc_version", "occupancy", "occupancy_queries", "ptxas_report",
           "role_registers", "sass", "sass_digests", "variant"]

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
# names none itself (the register budgets of probes/tlad_budget.py, the
# contracted or uncontracted builds of probes/fmad_time.py and parity.py)
VARIANTS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}

# The streamed-increment TL kernel ships without FMA contraction: contracted,
# its f32 tangents sit 2.7-3.3e-6 from jvp of the truth path, above the JAX
# package's TL parity of 1e-6 (cloudsc2jax/cli.py:288); uncontracted, 1.4e-7.
# It carries the standard contract's TL drop-in (cloudsc2_kernel_tl); its
# chunked twin is built the same way, so that the two give the same bits.
# The standard contract's TL+AD unit (run_tlad(backend="kernels"), which the
# f32 verdicts of tl/ad --kernels run) binds a second build of cloudsc2_tl
# with NO_FMA (tlad_kernel.launch_cloudsc2_tl_std); the stream contract keeps
# cloudsc2_tl's nvcc default build, as does the headline NL sweep.
NO_FMA = ("-fmad=false",)
SHIPPED_FLAGS = {"cloudsc2_tl_din": NO_FMA, "cloudsc2_tl_din_chunk": NO_FMA}


def _shipped(name: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The defines and extra nvcc flags a library is built with where
    nothing names others: the fused kernel's splits (kernels/fused_plan.py),
    which it cannot build without, and ``SHIPPED_FLAGS``."""
    defines: Tuple[str, ...] = ()
    if name == "cloudsc2_tlad_fused":
        from .fused_plan import defines as plan_defines

        defines = plan_defines()
    return defines, SHIPPED_FLAGS.get(name, ())


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
        defines, flags = VARIANTS.get(name, _shipped(name))
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
        # both files land whole, by rename: processes that start together
        # (the ranks of one launch) may build the same library at once, and
        # a reader finds the report before the library or neither
        report = out_dir / f"{name}.ptxas.{os.getpid()}.tmp"
        report.write_text(log)
        os.replace(report, out_dir / f"{name}.ptxas.txt")
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    for key in keys:
        if key not in _LIBRARIES:
            _LIBRARIES[key] = ctypes.CDLL(
                str(_build_dir(*key) / f"lib{key[0]}.so"))
    return [_LIBRARIES[key] for key in keys]


def bind(name: str, layouts: Mapping[str, Sequence], launchers: Mapping[str, Sequence],
         defines: Sequence[str] = (), strings: Sequence[str] = (),
         flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` (:func:`load_library` with ``defines`` and
    ``flags``) and, the first time for that build, check its argument
    layout against the wrapper's and declare its entries.

    ``layouts`` maps an ``*_abi`` function to the counts it must write (an
    entry ``None`` is read but not checked; the counts read are kept in
    ``lib.layouts``); ``launchers`` maps an entry's name to its argument
    types (it returns a ``cudaError_t``); ``strings`` names entries that
    take nothing and return a C string.  Raises ``RuntimeError`` on a
    layout mismatch."""
    lib = load_library(name, defines, flags)
    if getattr(lib, "_bound", False):
        return lib
    lib.layouts = {}
    for abi, expected in layouts.items():
        counts = (ctypes.c_int * len(expected))()
        fn = getattr(lib, abi)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        fn(counts)
        if any(e is not None and c != e for c, e in zip(counts, expected)):
            raise RuntimeError(
                f"{name}.cu: {abi} gives the layout {tuple(counts)}, the "
                f"wrapper expects {tuple(expected)}")
        lib.layouts[abi] = tuple(counts)
    for fn_name, argtypes in launchers.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for fn_name in strings:
        fn = getattr(lib, fn_name)
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    lib._bound = True
    return lib


_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def _argument(x):
    """A tensor as its pointer, a list or tuple as an array of pointers
    (``None`` a null pointer), anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr()
    if isinstance(x, (list, tuple)):
        return (ctypes.c_void_p * len(x))(*(None if t is None else t.data_ptr()
                                            for t in x))
    return x


def launch(lib: ctypes.CDLL, entry: str, like, *args, stream: bool = True) -> None:
    """Call ``entry`` of the bound library ``lib`` on ``like``'s card.

    ``like`` is a tensor, whose dtype picks ``<entry>_f32`` or
    ``<entry>_f64``, or a ``torch.device`` for an entry without a suffix.
    Each tensor of ``args`` goes as its pointer and each list or tuple of
    tensors as an array of pointers (``None`` a null pointer); the current
    stream goes last, unless ``stream`` is false (a query of the card, not a
    launch).  Raises ``RuntimeError`` if the entry returns a nonzero
    ``cudaError_t``."""
    if isinstance(like, torch.device):
        device, name = like, entry
    else:
        suffix = _SUFFIX.get(like.dtype)
        if suffix is None:
            raise TypeError(f"{entry} takes float32 or float64, not {like.dtype}")
        device, name = like.device, entry + suffix
    fn = getattr(lib, name)
    values = [_argument(x) for x in args]
    with torch.cuda.device(device):
        if stream:
            values.append(torch.cuda.current_stream().cuda_stream)
        err = fn(*values)
    if err != 0:
        what = "kernel launch" if stream else "query"
        raise RuntimeError(f"{entry} {what} failed: cudaError_t {err}")


# The counters of a kernel instance, in the order the libraries' occupancy
# entries write them (cloudsc2_occupancy::Counter in csrc/cloudsc2_occupancy.cuh).
OCCUPANCY = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")
_OCCUPANCY_READ: Dict[tuple, dict] = {}


def occupancy_queries(entry: str, switches: int) -> Dict[str, list]:
    """:func:`bind`'s declarations of ``<entry>_occupancy_f32|f64``, which
    take ``switches`` ints (the launch's own, after ``nlev``), then the
    :data:`OCCUPANCY` counters to fill."""
    return {f"{entry}_occupancy_{s}": [ctypes.c_int] * switches + [ctypes.POINTER(ctypes.c_int)]
            for s in ("f32", "f64")}


def occupancy(lib: ctypes.CDLL, entry: str, like: torch.Tensor, *switches: int) -> dict:
    """What the kernel instance that ``<entry>_f32|f64`` of the bound
    library ``lib`` launches on ``like``'s dtype with ``switches`` (the
    launch's ints after ``nlev``) costs an SM of ``like``'s card: ``dtype``
    (its bits), then :data:`OCCUPANCY`, as the library's
    ``<entry>_occupancy_f32|f64`` reads them (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's own
    block size and dynamic shared memory; ``csrc/cloudsc2_occupancy.cuh``).
    Read once per library, instance and card, then cached."""
    key = (lib, entry, like.dtype, like.device, switches)
    got = _OCCUPANCY_READ.get(key)
    if got is None:
        out = (ctypes.c_int * len(OCCUPANCY))()
        launch(lib, f"{entry}_occupancy", like, *switches, out, stream=False)
        got = _OCCUPANCY_READ[key] = {"dtype": 8 * like.element_size(),
                                      **dict(zip(OCCUPANCY, out))}
    return got


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


def sass(name: str, defines: Sequence[str] = (), flags: Sequence[str] = ()) -> str:
    """The SASS of a built library, as ``cuobjdump -sass`` prints it."""
    lib = _build_dir(*_key((name, defines, flags))) / f"lib{name}.so"
    tool = shutil.which("cuobjdump") or str(pathlib.Path(nvcc_path()).parent
                                             / "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s*(.*?)\s*;")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")
_REGISTER = re.compile(r"\bR(\d+)\b")


def _successors(code: List[Tuple[int, str]], index: Dict[int, int], i: int):
    """Where control goes after instruction ``i``: a branch's or call's
    target, and the next instruction unless the branch or exit is
    unconditional."""
    text = code[i][1]
    predicated = text.startswith("@")
    op = _opcode(text)
    nxt = [i + 1] if i + 1 < len(code) else []
    if op in ("BRA", "CALL"):
        m = _TARGET.search(text)
        target = [index[int(m.group(1), 16)]] if m and int(m.group(1), 16) in index else []
        return target + (nxt if predicated or op == "CALL" else [])
    if op in ("EXIT", "RET"):
        return nxt if predicated else []
    return nxt


def _entry_code(text: str, marks: Sequence[str]) -> List[Tuple[int, str]]:
    """(address, instruction) of the first kernel entry in the SASS ``text``
    whose mangled name holds every one of ``marks``."""
    code: List[Tuple[int, str]] = []
    found = False
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            if found:
                break
            found = all(mark in m.group(1) for mark in marks)
            continue
        m = _INSTRUCTION.match(line)
        if found and m:
            code.append((int(m.group(1), 16), m.group(2)))
    if not found:
        raise AssertionError(f"no kernel entry matches {marks}")
    return code


def _opcode(text: str) -> str:
    return text.split()[1 if text.startswith("@") else 0].split(".")[0]


# the anonymous namespace of a translation unit in a mangled name, which
# holds hashes of the unit's path and contents
_ANONYMOUS = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")


def sass_digests(text: str) -> Dict[str, str]:
    """Per kernel entry in the SASS ``text`` (:func:`sass`), the sha256 of
    its instructions as ``cuobjdump -sass`` prints them (addresses and
    encodings included): equal digests, equal code.  Entries are keyed by
    their mangled names with any anonymous namespace written
    ``_GLOBAL__N_``, so that builds of one source from two places compare."""
    out: Dict[str, str] = {}
    entry, h = None, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            entry, h = _ANONYMOUS.sub("_GLOBAL__N_", m.group(1)), hashlib.sha256()
            out[entry] = ""
            continue
        m = _INSTRUCTION.match(line)
        if entry is not None and m:
            h.update(line.strip().encode())
            out[entry] = h.hexdigest()
    return out


def library_digest(digests: Dict[str, str]) -> str:
    """One sha256 over a library's entries and their :func:`sass_digests`."""
    h = hashlib.sha256()
    for entry in sorted(digests):
        h.update(f"{entry} {digests[entry]}\n".encode())
    return h.hexdigest()


def loop_census(text: str, marks: Sequence[str], detail: Sequence[str] = ()) -> dict:
    """The instructions of the outermost loop of the first kernel entry in
    the SASS ``text`` whose mangled name holds every one of ``marks`` (the
    code between the backward branch that spans the most instructions and
    its target: a sweep's level loop, whose body is unrolled): their count
    and the count of each opcode, ``{"instructions": n, "ops": {op: n}}``;
    with ``detail``, also the count of each form (opcode and modifiers,
    ``MUFU.RCP``) of the opcodes it names, under ``"detail"``."""
    code = _entry_code(text, marks)
    index = {addr: i for i, (addr, _) in enumerate(code)}
    best = None
    for i, (_, text) in enumerate(code):
        if _opcode(text) != "BRA":
            continue
        m = _TARGET.search(text)
        j = index.get(int(m.group(1), 16)) if m else None
        if j is not None and j <= i and (best is None or i - j > best[1] - best[0]):
            best = (j, i)
    if best is None:
        raise AssertionError(f"no loop in the kernel entry matching {marks}")
    ops: Dict[str, int] = {}
    forms: Dict[str, int] = {}
    for _, text in code[best[0]:best[1] + 1]:
        op = _opcode(text)
        ops[op] = ops.get(op, 0) + 1
        if op in detail:
            form = text.split()[1 if text.startswith("@") else 0]
            forms[form] = forms.get(form, 0) + 1
    census = {"instructions": best[1] - best[0] + 1, "ops": ops}
    return {**census, "detail": forms} if detail else census


def role_registers(name: str, marks: Sequence[str], defines: Sequence[str] = (),
                   flags: Sequence[str] = ()) -> dict:
    """Registers and local-memory spills per warpgroup role of the first
    kernel entry of ``name`` whose mangled name holds every one of
    ``marks``, read from its SASS: ptxas' report gives the launch count
    only.  A role's code is every instruction reachable from its
    ``SETMAXREG`` (``DEALLOC`` lowers, the TL role's; ``TRY_ALLOC`` raises,
    the AD role's), following branches; per role the highest register index
    used plus one, the count of ``STL`` and ``LDL`` instructions and of
    instructions.  ``{"setmaxreg": n, "tl": {...}, "ad": {...}}``
    (``setmaxreg`` 0: ptxas dropped the instruction, and no role is
    reported)."""
    code = _entry_code(sass(name, defines, flags), marks)
    index = {addr: i for i, (addr, _) in enumerate(code)}
    starts = [i for i, (_, text) in enumerate(code) if "SETMAXREG" in text]
    out: dict = {"setmaxreg": len(starts)}
    for start in starts:
        role = "tl" if "DEALLOC" in code[start][1] else "ad"
        seen, todo = set(), [start]
        while todo:
            i = todo.pop()
            if i not in seen:
                seen.add(i)
                todo += _successors(code, index, i)
        texts = [code[i][1] for i in seen]
        ops = [_opcode(t) for t in texts]
        regs = [int(r) for t in texts for r in _REGISTER.findall(t)]
        out[role] = {"registers": max(regs, default=-1) + 1,
                     "stl": ops.count("STL"), "ldl": ops.count("LDL"),
                     "instructions": len(texts)}
    return out
