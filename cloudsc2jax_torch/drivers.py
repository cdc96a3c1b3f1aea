"""Run harnesses: the nonlinear sweep, the TL+AD work unit, chunked
streaming past the device's memory, the Taylor test and the adjoint
symmetry test (reference ``src/cloudsc2_nl/cloudsc_driver_mod.F90``,
``src/cloudsc2_tl/cloudsc_driver_tl_mod.F90`` and
``src/cloudsc2_ad/cloudsc_driver_ad_mod.F90``).

Port of :func:`cloudsc2jax.drivers.run_nl`, ``run_tlad``, ``map_columns``,
``run_chunked``, ``taylor_test`` and ``adjoint_test``.  Each takes a ``mesh``
(:class:`~cloudsc2jax_torch.dist.ColumnMesh`) for the column decomposition
over lanes and processes, as the JAX package's take a ``Mesh``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import sys
from functools import partial
from typing import Optional

import numpy as np
import torch

from . import spans
from .constants import Params
from .dist import ColumnMesh
from .kernels.cloudsc2_kernel import (
    cloudsc2_nl,
    flux_rows,
    flux_slots,
    kernel_prelude,
    unblock_outputs,
)
from .kernels.tlad_kernel import (
    ad_from_seeds,
    cloudsc2_ad,
    cloudsc2_tl,
    cloudsc2_tl_std,
    tl_contract,
    to_levels_major,
)
from .physics.cloudsc2 import Cloudsc2Inputs, cloudsc2
from .state import tile_stored_columns

__all__ = ["DSCALE", "AdjointResult", "TaylorResult", "adjoint_test",
           "chunk_columns", "chunk_loop", "map_columns", "run_chunked", "run_nl",
           "run_tlad", "taylor_test"]

# the drivers' canonical perturbation scale, dx = DSCALE*x
# (cloudsc_driver_{tl,ad}_mod.F90:156-171): the work unit's increments and
# the CLI's adjoint identity <dx, M^T M dx> use the same value
DSCALE = 0.01


def run_nl(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    ldrain1d: bool = False,
    backend: str = "streams",
    mesh: Optional[ColumnMesh] = None,
):
    """Forward (nonlinear) run over all columns
    (cloudsc_driver_mod.F90:73-119).  CUDA tensors run the kernel, CPU
    tensors its plain version.

    With a ``mesh``, ``inputs`` is a list of one input per local lane, each
    on its lane's device (``dist.shard_inputs``, or each lane's
    ``device_kernel_inputs(col_offset=)``), and the result is the list of
    each lane's outputs: the same launches per lane, enqueued lane after
    lane, so lanes on distinct cards run at once (``shard_map_columns``,
    ``cloudsc2jax/drivers.py:112-136``).

    ``backend`` (the JAX package's name in brackets):

    * ``"streams"`` [``"pallas_blocked"``], the default and the main path:
      levels-major inputs (``device_kernel_inputs``) through the fused
      SATUR+CLOUDSC2 sweep; returns its 8 levels-major streams
      (``Cloudsc2StreamOutputs``).  A caller that needs the ``(ncol,
      nlev)`` contract assembles it once with
      :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.unblock_outputs`,
      as the CLI does before validating.
    * ``"kernels"`` [``"pallas"``]: the standard ``(ncol, nlev)`` contract
      in and out, through the same sweep; the inputs are made levels-major
      once (no copy for transposed views of levels-major tensors, as
      ``state.device_inputs`` builds them), and the sweep writes its flux
      rows into the contract's flux fields, which one assembly finishes in
      place (:func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.
      assemble_contract`).
    * ``"truth"`` [``"xla"``]: :func:`~cloudsc2jax_torch.physics.cloudsc2.
      cloudsc2` on the standard contract, the level loop in PyTorch.
    """
    if mesh is not None:
        return _map_lanes(mesh, inputs, partial(run_nl, params=params,
                                                ldrain1d=ldrain1d, backend=backend))
    _check_backend(backend)
    with spans.span("run_nl", inputs.pt):
        if backend == "streams":
            return cloudsc2_nl(inputs, params, ldrain1d=ldrain1d)
        if backend == "kernels":
            lm = to_levels_major(inputs._replace(pqs=None))
            flux = flux_rows(lm.pt)
            out = cloudsc2_nl(lm, params, ldrain1d=ldrain1d, out=flux_slots(flux))
            return unblock_outputs(out, params, flux=flux)
        return cloudsc2(inputs, params, ldrain1d=ldrain1d)


def _check_backend(backend: str) -> None:
    if backend not in ("streams", "kernels", "truth"):
        raise ValueError(f"backend must be 'streams', 'kernels' or 'truth', "
                         f"not {backend!r}")


def _tree_map(fn, tree):
    """``fn`` over the tensors of nested tuples (NamedTuples kept), ``None``
    left as it is; ``fn`` gets one leaf of each tree."""
    return _tree_map_n(fn, [tree])


def _tree_map_n(fn, trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    mapped = [_tree_map_n(fn, list(leaves)) for leaves in zip(*trees)]
    return type(first)(*mapped) if hasattr(first, "_fields") else type(first)(mapped)


def map_columns(fn, tree, nproma: int):
    """``fn`` over sequential NPROMA-sized column blocks of ``tree`` (nested
    tuples of tensors whose first axis is the column), results joined back
    into the same tree (``cloudsc2jax/drivers.py:141-171``; a loop over the
    blocks is ``lax.map``'s counterpart).

    The reference's NPROMA blocking (cloudsc_driver_mod.F90:82) revived for
    working-set control: reverse mode over the level loop stores per-level
    residuals in proportion to the columns, so a large batch runs as
    sequential blocks.  A partial last block is padded with replicas of
    column 0 and sliced back (columns are independent and the inputs are
    cyclic expansions, so the padding is more replicas; the reference's
    ICEND, cloudsc_driver_mod.F90:83)."""
    ncol = next(_leaves(tree)).shape[0]
    out = None
    for start in range(0, ncol, nproma):
        stop = min(start + nproma, ncol)
        res = fn(_tree_map(partial(_block, start=start, stop=stop, nproma=nproma),
                           tree))
        if out is None:
            # the whole result allocated once, as lax.map stacks into one
            # buffer: a block's result is copied in and freed
            out = _tree_map(lambda r: r.new_empty((ncol, *r.shape[1:])), res)

        def put(o, r, start=start, stop=stop):
            o[start:stop] = r[:stop - start]

        _tree_map_n(put, [out, res])
        del res
    return out


def _block(x: torch.Tensor, *, start: int, stop: int, nproma: int) -> torch.Tensor:
    """Rows ``start:stop`` of ``x``, padded to ``nproma`` with replicas of row
    0, as a tensor of its own, dense in ``x``'s own order of dimensions: the
    columns of a levels-major tensor's transposed view stay levels-major, so
    that the truth path reads each level of a block as one row, as it does
    on the whole batch.  A block that stays a view of the batch makes the
    reverse pass keep about twice the memory (PERF.md, section 5)."""
    b = x[start:stop]
    npad = nproma - (stop - start)
    if npad:
        b = torch.cat([b, x[:1].expand(npad, *x.shape[1:])])
    order = sorted(range(x.dim()), key=x.stride, reverse=True)
    dense = b.permute(order).clone(memory_format=torch.contiguous_format)
    return dense.permute([order.index(d) for d in range(x.dim())])


def _truth_unit(inputs: Cloudsc2Inputs, params: Params, *, lregcl: bool,
                ldrain1d: bool, remat: bool):
    """The TL+AD unit on the truth path: ``jvp`` for the tangent, ``vjp``
    (level-checkpointed with ``remat``) for the adjoint."""
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    d_inputs = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
    out, dout = torch.func.jvp(f, (inputs,), (d_inputs,))
    _, vjp_fn = torch.func.vjp(partial(f, remat_level=remat), inputs)
    (adj,) = vjp_fn(dout)
    return out, dout, adj


def run_tlad(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    remat: bool = True,
    nproma: Optional[int] = None,
    write_primal: bool = True,
    backend: str = "streams",
    mesh: Optional[ColumnMesh] = None,
):
    """One TL+AD sweep, the production 4D-Var work unit
    (cloudsc_driver_ad_mod.F90:158-237): the canonical ``DSCALE·x``
    increments go through the tangent-linear, and the resulting output
    perturbations come back through the adjoint.  Returns ``(outputs,
    d_outputs, input_adjoints)``.  CUDA tensors run the kernels, CPU tensors
    their plain versions.

    ``backend`` (the JAX package's name in brackets):

    Both kernel backends compute :func:`kernel_prelude` once per unit and
    hand it to both sweeps.

    * ``"streams"`` [``"pallas_blocked"``], the default: ``inputs`` are
      levels-major with ``pqs`` (``device_kernel_inputs(..., pqs=True)``).
      The TL sweep forms the increments in registers and writes the 3 carry
      checkpoints; the reverse sweep pulls the tangent image back from
      them.  Results are the 8 levels-major primal streams (``None`` with
      ``write_primal=False``, the reference AD driver's contract), the 8
      tangent streams, and the levels-major adjoints of the 16 inputs.
    * ``"kernels"`` [``"pallas"``]: the standard contract through the
      kernels.  ``inputs`` are ``(ncol, nlev)``; the adjoint is seeded with
      the 10-field tangent.  Results are two :class:`Cloudsc2Outputs` and a
      ``(ncol, nlev)`` :class:`Cloudsc2Inputs`.  The inputs are transposed
      to levels-major once for both sweeps.  The TL sweep
      (:func:`~cloudsc2jax_torch.kernels.tlad_kernel.cloudsc2_tl_std`) forms
      the increments in registers, as ``"streams"`` does, in a build of the
      sweep without FMA contraction (the f32 TL parity of
      ``cli.measure_f32_verdicts``), and writes the primal and the tangent
      into the contracts' fields and the 3 carry checkpoints; ``tl_contract``
      assembles both contracts in place, the tangent's with the reverse
      sweep's seeds in the same launch; ``ad_from_seeds`` runs the reverse
      sweep from those checkpoints.
    * ``"truth"`` [``"xla"``]: ``torch.func.jvp``/``vjp`` of
      :func:`~cloudsc2jax_torch.physics.cloudsc2.cloudsc2`, the f64
      validation path, same contract as ``"kernels"``.  ``remat`` (default
      on, as in the JAX package) checkpoints the level body of the ``vjp``
      (``remat_level``); ``nproma`` runs the unit over sequential column
      blocks (:func:`map_columns`).  Both apply to this backend only; the
      kernel backends ignore them.

    With a ``mesh``, ``inputs`` holds one input per local lane and the
    result is each lane's triple, as for :func:`run_nl`
    (``cloudsc2jax/drivers.py:230-235``).
    """
    if mesh is not None:
        return _map_lanes(mesh, inputs, partial(
            run_tlad, params=params, lregcl=lregcl, ldrain1d=ldrain1d,
            remat=remat, nproma=nproma, write_primal=write_primal,
            backend=backend))
    if not write_primal and backend != "streams":
        raise ValueError("write_primal=False requires backend='streams' "
                         f"(got {backend!r})")
    _check_backend(backend)
    with spans.span("run_tlad", inputs.pt):
        if backend == "streams":
            pre = kernel_prelude(inputs, params)
            out, dout, ckpts = cloudsc2_tl(inputs, params, dscale=DSCALE, lregcl=lregcl,
                                           ldrain1d=ldrain1d, write_primal=write_primal,
                                           pre=pre)
            adj = cloudsc2_ad(inputs, dout, ckpts, params, lregcl=lregcl,
                              ldrain1d=ldrain1d, pre=pre)
            return out, dout, adj
        if backend == "kernels":
            lm = to_levels_major(inputs)
            kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, pre=kernel_prelude(lm, params))
            out, dout, seeds, ckpts = tl_contract(
                lambda slots: cloudsc2_tl_std(lm, params, dscale=DSCALE, out=slots, **kw),
                lm.pt, params, seeds=True)
            adj = ad_from_seeds(lm, seeds, ckpts, params, **kw)
            return tuple(type(t)(*(x.T for x in t)) for t in (out, dout, adj))
        unit = partial(_truth_unit, params=params, lregcl=lregcl,
                       ldrain1d=ldrain1d, remat=remat)
        return unit(inputs) if nproma is None else map_columns(unit, inputs, nproma)


def _map_lanes(mesh: ColumnMesh, inputs, fn) -> list:
    """``fn`` on each lane's inputs with the lane's card current; raises
    unless ``inputs`` holds one input per lane, on that lane's device."""
    if not isinstance(mesh, ColumnMesh):
        raise TypeError(f"mesh must be a dist.ColumnMesh, not {type(mesh).__name__}")
    for lane, (x, dev) in enumerate(zip(inputs, mesh.lanes)):
        if x.pt.device != dev:
            raise ValueError(f"lane {lane}'s inputs are on {x.pt.device}, "
                             f"its lane is {dev}")
    return mesh.map(fn, inputs)


# ---------------------------------------------------------------- chunked
class _LRUCache:
    """A small bounded cache (``cloudsc2jax/drivers.py:74``).  Keys hold
    ``id(state)``; the value keeps the state alive, so a live entry's id
    cannot be recycled, and callers check ``hit[0] is state`` for the rest.
    Bounded, so that a long-running process does not keep every chunk size's
    device tensors alive."""

    def __init__(self, maxsize: int = 8):
        self._d = collections.OrderedDict()
        self.maxsize = maxsize

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


# (state, the stored columns on the device, the generated chunk | None) per
# chunked configuration
_CHUNK_CACHE = _LRUCache()


def chunk_columns(state, chunk: int, *, variant: str = "nl",
                  sublanes: Optional[int] = None, fused_gen: bool = False,
                  lanes: int = 1) -> int:
    """The columns of one chunk as :func:`run_chunked` executes it over
    ``lanes`` lanes in all (a mesh's ``size``): whole groups of
    ``lanes·sublanes·128`` columns (the JAX package's blocks, default 128
    for ``nl`` and 64 for ``tlad``, and as many for every lane), so that the
    same call executes the same columns in both packages; with ``fused_gen``
    rounded UP to ``lcm(lanes·sublanes·128, klon_file)``, the period of the
    cyclic expansion (``cloudsc2jax/drivers.py:576-587``)."""
    if variant not in ("nl", "tlad"):
        raise ValueError(f"variant must be 'nl' or 'tlad', not {variant!r}")
    if sublanes is None:
        sublanes = 128 if variant == "nl" else 64
    bc = sublanes * 128 * lanes
    if fused_gen:
        al = math.lcm(bc, state.klon_file)
        return -(-chunk // al) * al
    return (chunk // bc) * bc or bc


def checksum(out) -> torch.Tensor:
    """The decomposition-invariant probe: the sum of every leaf of ``out``
    (``None`` skipped), each summed in float32 (``cloudsc2jax/drivers.py:
    635-643``), as a 0-d tensor on the outputs' device."""
    return sum(torch.sum(o, dtype=torch.float32) for o in _leaves(out))


def slice_probe(out, variant: str) -> torch.Tensor:
    """The thin probe (``cloudsc2jax/drivers.py:645-658``): the first two
    values of each leaf, and for ``tlad`` the adjoint's surface row of paph
    and the first two values of its plu.  The JAX package's compiler would
    drop unconsumed work; eager PyTorch runs every launch, so this probe
    changes what is read, not what runs."""
    extra = 0.0
    if variant == "tlad":
        adj = out[2]
        extra = (torch.sum(adj.paph[-1], dtype=torch.float32)
                 + torch.sum(_first_two(adj.plu), dtype=torch.float32))
    return extra + sum(torch.sum(_first_two(o), dtype=torch.float32)
                       for o in _leaves(out))


def _first_two(x: torch.Tensor) -> torch.Tensor:
    """``x.ravel()[:2]`` without the copy that ``ravel`` makes of a
    transposed view (the standard contract's fields): the first two values
    of the first row."""
    return x[(0,) * (x.dim() - 1)][:2]


def _leaves(tree):
    for x in tree:
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            yield x
        else:
            yield from _leaves(x)


def chunk_loop(
    state,
    ngptot: int,
    *,
    variant: str = "nl",
    chunk: int = 524288,
    dtype: torch.dtype = torch.float32,
    sublanes: Optional[int] = None,
    lregcl: bool = True,
    device="cuda",
    mesh=None,
    fused_gen: bool = False,
    probe: str = "checksum",
    write_primal: bool = True,
):
    """:func:`run_chunked` without its one read of the result: returns
    ``(columns_processed, acc)``, ``acc`` the 0-d float32 accumulator on the
    device, not yet read; with a ``mesh`` the list of each local lane's
    accumulator, on the lane's device.  Once a state's stored columns are on
    the device (the first call for a dtype and device uploads them), nothing
    in the loop synchronises with the host: a CUDA-gated test and
    ``chip_smoke.py`` run it under ``torch.cuda.set_sync_debug_mode(
    "error")``."""
    if mesh is not None and not isinstance(mesh, ColumnMesh):
        raise TypeError(f"mesh must be a dist.ColumnMesh, not {type(mesh).__name__}")
    if probe not in ("checksum", "slice"):
        raise ValueError(f"probe must be 'checksum' or 'slice', not {probe!r}")
    if not write_primal and variant != "tlad":
        raise ValueError("write_primal=False applies to variant='tlad' only")
    device = torch.device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"run_chunked: device {device.type}, but the mesh's "
                         f"lanes are {mesh.device_type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_chunked: no CUDA device is available")
    if sublanes is None:
        sublanes = 128 if variant == "nl" else 64
    # lane l of this process runs the columns [g·local, (g+1)·local) of
    # every chunk, g its lane in the whole mesh (cloudsc2jax/drivers.py:
    # 685-725)
    lanes = [device] if mesh is None else mesh.lanes
    first = 0 if mesh is None else mesh.global_lane(0)
    chunk = chunk_columns(state, chunk, variant=variant, sublanes=sublanes,
                          fused_gen=fused_gen,
                          lanes=1 if mesh is None else mesh.size)
    local = chunk // (1 if mesh is None else mesh.size)
    key = (id(state), variant, sublanes, chunk, dtype, lregcl, fused_gen,
           probe, write_primal, tuple(lanes), first)
    hit = _CHUNK_CACHE.get(key)
    if hit is None or hit[0] is not state:
        bases = [state.stored_inputs(dtype, dev, pqs=variant == "tlad")
                 for dev in lanes]
        # one generation feeds every chunk: with the chunk a whole period
        # of the cyclic expansion, every chunk's inputs are value-identical
        blks = ([tile_stored_columns(b, local, (first + lane) * local)
                 for lane, b in enumerate(bases)] if fused_gen else None)
        hit = _CHUNK_CACHE[key] = (state, bases, blks)
    _, bases, blks = hit

    if variant == "nl":
        def kernel(inputs):
            return run_nl(inputs, state.params, backend="streams")
    else:
        def kernel(inputs):
            return run_tlad(inputs, state.params, lregcl=lregcl,
                            write_primal=write_primal, backend="streams")

    def force(out):
        return checksum(out) if probe == "checksum" else slice_probe(out, variant)

    def context(lane):
        return contextlib.nullcontext() if mesh is None else mesh.context(lane)

    nchunks = -(-ngptot // chunk)
    accs = [torch.zeros((), dtype=torch.float32, device=dev) for dev in lanes]
    for i in range(nchunks):
        for lane in range(len(lanes)):
            with context(lane):
                # one expression, so that a chunk's inputs and outputs are
                # free before the next chunk allocates its own
                accs[lane] = accs[lane] + force(kernel(
                    blks[lane] if fused_gen else tile_stored_columns(
                        bases[lane], local, i * chunk + (first + lane) * local)))
    return nchunks * chunk, (accs[0] if mesh is None else accs)


def run_chunked(state, ngptot: int, **kwargs):
    """Stream batches larger than the device's memory through the kernels
    (``cloudsc2jax/drivers.py:505-606``).

    Each chunk is generated on the device from the stored columns at its
    global column offset (``col_offset = i·chunk``, the cyclic expansion of
    expand_mod.F90), run through ``run_nl(backend="streams")`` (``variant=
    "nl"``, the main path: prelude and kernel #1) or ``run_tlad(backend=
    "streams")`` (``"tlad"``: kernels #3 and #5, one prelude per unit;
    ``write_primal=False`` drops the 8 primal streams), reduced to a scalar
    and added to one device accumulator; the host reads it once, at the
    end.  CUDA tensors (``device="cuda"``, the default) run the kernels,
    ``device="cpu"`` their plain versions.  The keywords are
    :func:`chunk_loop`'s: the JAX package's signature with ``interpret``
    replaced by ``device`` (``variant="nl"``, ``chunk=524288``,
    ``dtype=torch.float32``, ``sublanes=None``, ``lregcl=True``,
    ``device="cuda"``, ``mesh=None``, ``fused_gen=False``,
    ``probe="checksum"``, ``write_primal=True``, this one for ``tlad``
    only).

    Returns ``(columns_processed, checksum)``: ``columns_processed =
    ceil(ngptot/chunk)·chunk`` is the padded count actually executed, the
    chunk rounded by :func:`chunk_columns` (``sublanes`` is kept only for
    that rounding).

    ``mesh`` (a :class:`~cloudsc2jax_torch.dist.ColumnMesh` of ``device``'s
    type) decomposes every chunk over the mesh's lanes in all processes:
    the chunk is rounded to whole ``mesh.size·sublanes·128`` groups, each
    lane generates and runs its own equal share of every chunk at its
    global offset, keeps its own accumulator, and one reduction over the
    lanes and the ranks runs after the loop, the only wait it adds; every
    rank returns the same total.  The order of the sums differs from the
    JAX package's per-chunk ``psum``: the same columns agree to f32
    reassociation, not bit for bit.  ``probe="checksum"`` sums every leaf of every chunk's
    results in float32: the same global columns give the same value for any
    chunk size up to float32 reassociation.  ``probe="slice"`` reads
    :func:`slice_probe` instead, as the benchmark's timed chain does.

    ``fused_gen=True`` rounds the chunk up to a whole period of the
    expansion and generates it once for the whole run; its checksum equals
    the regenerating path's bit for bit for the same executed columns.

    The device-resident stored columns, and with ``fused_gen`` the
    generated chunk, stay in a small LRU cache keyed by the configuration.
    """
    columns, acc = chunk_loop(state, ngptot, **kwargs)
    mesh = kwargs.get("mesh")
    if mesh is None:
        return columns, float(acc)
    return columns, float(mesh.reduce(acc, "sum"))


# ------------------------------------------------------------------ Taylor
@dataclasses.dataclass
class TaylorResult:
    norms: np.ndarray  # ZNORMG(10): max over blocks of the mean error ratio
    istart: int  # first lambda index (1-based) with |1-norm|<0.5
    penalty: int  # ITEST penalty
    passed: bool

    def report(self, file=None):
        file = file or sys.stderr
        print(" TL Taylor test ", file=file)
        print("                Lambda   Result", file=file)
        for i, v in enumerate(self.norms):
            print(f" {i+1:4d}  {v:22.14f}", file=file)
        print("   ==============================================   ", file=file)
        if self.passed:
            print(f"       TEST PASSED, penalty {self.penalty}", file=file)
        else:
            print(f"       TEST FAILED, err {self.penalty}", file=file)
        print("   ==============================================   ", file=file)


def _perturbations(inputs: Cloudsc2Inputs, zero_supsat: bool) -> Cloudsc2Inputs:
    """The reference harnesses' canonical increments: 0.01·x for all 16 inputs
    (cloudsc_driver_tl_mod.F90:156-171); the AD driver zeroes the obsolete
    supersaturation perturbation (cloudsc_driver_ad_mod.F90:139)."""
    d = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
    if zero_supsat:
        d = d._replace(psupsat=torch.zeros_like(d.psupsat))
    return d


def _block_sums(field_minus_ref: torch.Tensor, nproma: int) -> torch.Tensor:
    """Sum (ncol, nlev…) tensors over the level axis and nproma-sized
    column blocks -> (nblocks,)."""
    ncol = field_minus_ref.shape[0]
    flat = field_minus_ref.reshape(ncol, -1).sum(dim=1)
    nblocks = -(-ncol // nproma)
    pad = nblocks * nproma - ncol
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(nblocks, nproma).sum(dim=1)


def taylor_test(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    nproma: int = 1,
    lregcl: bool = False,
    ldrain1d: bool = False,
    mesh: Optional[ColumnMesh] = None,
) -> TaylorResult:
    """The TL Taylor/gradient test (cloudsc_driver_tl_mod.F90:126-311), on
    the truth path and the inputs' device.

    For λ = 10⁻¹ … 10⁻¹⁰ compares the nonlinear difference against λ·TL:
    for every NPROMA block and each of the 10 output fields with a
    non-negligible TL sum, accumulates |Σ(NL(x+λδx)−NL(x)) / Σ(λ·TLδx)|;
    the per-block mean must converge to 1 with a V-shaped error curve.
    The reference runs this with NPROMA=1 (per-column statistics), the
    default here.

    With a ``mesh``, ``inputs`` holds one input per local lane: each lane
    blocks its own columns, and the ten norms (maxima over blocks) are
    reduced with MAX over the lanes and the ranks, so that every rank
    reaches the same verdict (``reduction(max:znormg)``,
    cloudsc_driver_tl_mod.F90:125,251).
    """
    kw = dict(params=params, nproma=nproma, lregcl=lregcl, ldrain1d=ldrain1d)
    if mesh is None:
        norms = _taylor_norms(inputs, **kw).double().cpu().numpy()
    else:
        lanes = _map_lanes(mesh, inputs, partial(_taylor_norms, **kw))
        norms = mesh.reduce(lanes, "max").numpy()
    return _taylor_verdict(norms)


def _taylor_norms(inputs: Cloudsc2Inputs, params: Params, *, nproma: int,
                  lregcl: bool, ldrain1d: bool) -> torch.Tensor:
    """ZNORMG(10) of :func:`taylor_test` over ``inputs``' columns, on their
    device."""
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    d_inputs = _perturbations(inputs, zero_supsat=False)

    base, d_out = torch.func.jvp(f, (inputs,), (d_inputs,))

    eps = float(torch.finfo(base.tenl_t.dtype).eps)

    def norms_for(lam):
        pert = f(Cloudsc2Inputs(*(x + lam * dx for x, dx in zip(inputs, d_inputs))))
        znorm = 0.0
        zcount = 0.0
        for fld in range(len(base)):
            num = _block_sums(pert[fld] - base[fld], nproma)
            den = _block_sums(d_out[fld] * lam, nproma)
            active = den.abs() > eps
            den_safe = torch.where(active, den, 1.0)
            znorm = znorm + torch.where(active, (num / den_safe).abs(), 0.0)
            zcount = zcount + active.to(num.dtype)
        # mean over active fields per block, max over blocks
        # (reduction(max:znormg), cloudsc_driver_tl_mod.F90:125,251)
        any_active = zcount > 0
        ratio = torch.where(any_active,
                            znorm / torch.where(any_active, zcount, 1.0), 0.0)
        return ratio.max()

    return torch.stack([norms_for(10.0 ** -(i + 1)) for i in range(10)])


def _taylor_verdict(norms: np.ndarray) -> TaylorResult:
    """The evaluation of the ten norms (cloudsc_driver_tl_mod.F90:272-311)."""
    err = np.abs(1.0 - norms)
    istart = 0
    for i in range(10):
        if err[i] < 0.5:
            istart = i + 1
            break
    if istart == 0 or istart > 4:
        return TaylorResult(norms=norms, istart=istart, penalty=13, passed=False)
    itest = -10
    inegat = 1
    for i in range(istart - 1, 9):
        itempnegat = 1 if err[i + 1] / err[i] < 1.0 else 0
        if inegat > itempnegat:
            itest += 10
        inegat = itempnegat
    if itest == -10:
        itest = 11  # no change of sign at all
    if err[istart - 1 : 10].min() > 1.0e-5:
        itest += 7  # hard limit
    if err[istart - 1 : 10].min() > 1.0e-6:
        itest += 5  # soft limit
    return TaylorResult(norms=norms, istart=istart, penalty=itest, passed=itest <= 5)


# ----------------------------------------------------------------- Adjoint
@dataclasses.dataclass
class AdjointResult:
    max_error: float  # in units of the working precision's machine epsilon
    passed: bool

    def report(self, file=None):
        file = file or sys.stderr
        print(" AD TEST ", file=file)
        print(
            f" The maximum error is {self.max_error:.6f}"
            " times the zero of the machine. ",
            file=file,
        )
        print("   =============================  ", file=file)
        print(
            "   =           TEST OK         = "
            if self.passed
            else "   =        TEST FAILED        = ",
            file=file,
        )
        print("   =============================  ", file=file)


def adjoint_test(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    threshold: float = 1.0e4,
    mesh: Optional[ColumnMesh] = None,
) -> AdjointResult:
    """Adjoint symmetry test ⟨Mδx, Mδx⟩ = ⟨δx, MᵀMδx⟩ per column
    (cloudsc_driver_ad_mod.F90:110-293) on the truth path, with LREGCL
    active as in the AD entry program (cloudsc2_ad/dwarf_cloudsc.F90:105).
    With a ``mesh``, ``inputs`` holds one input per local lane and the
    largest error is reduced with MAX over the lanes and the ranks."""
    kw = dict(params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    if mesh is None:
        max_err = float(_adjoint_errors(inputs, **kw))
    else:
        lanes = _map_lanes(mesh, inputs, partial(_adjoint_errors, **kw))
        max_err = float(mesh.reduce(lanes, "max"))
    return AdjointResult(max_error=max_err, passed=max_err < threshold)


def _adjoint_errors(inputs: Cloudsc2Inputs, params: Params, *, lregcl: bool,
                    ldrain1d: bool) -> torch.Tensor:
    """The largest per-column error of :func:`adjoint_test`, in working
    precision epsilons, as a 0-d tensor on the inputs' device."""
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    d_inputs = _perturbations(inputs, zero_supsat=True)
    # machine epsilon of the WORKING precision: the reference compares
    # against EPSILON(1.0_JPRB) (cloudsc_driver_ad_mod.F90:258), which is
    # eps32 under -DSINGLE, so an f32 run must be judged in f32 units
    eps = float(torch.finfo(inputs.pt.dtype).eps)

    _, d_out = torch.func.jvp(f, (inputs,), (d_inputs,))
    norm1 = sum((y ** 2).reshape(y.shape[0], -1).sum(dim=1) for y in d_out)
    _, vjp_fn = torch.func.vjp(f, inputs)
    (adj,) = vjp_fn(d_out)
    norm2 = sum((a * b).reshape(a.shape[0], -1).sum(dim=1)
                for a, b in zip(d_inputs, adj))
    # per-column error in machine epsilons; only the max reaches the host
    norm3 = (norm1 - norm2).abs() / eps
    norm3 = torch.where(
        norm2 != 0.0,
        norm3 / torch.where(norm2 != 0.0, norm2.abs(), 1.0),
        norm3,
    )
    return norm3.max()
