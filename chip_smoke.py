#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card: the
nonlinear sweep, the TL+AD work unit, the standalone TL and AD variants
(Taylor test, adjoint test, f32 verdicts through the kernels), the
``kernel_ab`` harness over the work unit's schedules (two-kernel, fused,
int16-encoded), the NL-side experiments (the encoded and the resident
NL sweeps, the window-matched bandwidth probe ``bw_probe`` and the
``encoding_study``), chunked streaming past the card's memory
(``drivers.run_chunked``), the benchmark ``cloudsc2jax_torch.bench`` and the
CLI's profiler and golden writer, the column decomposition over two
processes, the truth path's level checkpoint and NPROMA blocks, the
bench's truth and kernel modes, the roofline of every kernel, the native
host shim and the evidence battery, and the TPU kernels' other schedules
(the 17-stream adjoint convention, C levels a step, bfloat16 payloads of the
encoded TL and AD sweeps).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Card: a CUDA device must be present; print its name and power limit.
2. Build: compile ``cloudsc2jax_torch/csrc/cloudsc2_{nl,tl,tl_din,ad,
   tl_enc,ad_enc,tlad_fused,nl_enc,nl_res,ad_xscat,ad_chunk,tl_chunk,
   tl_din_chunk,fwd_chunk,tl_enc_bf16,ad_enc_bf16,prelude}.cu``, ``cloudsc2_tl.cu``
   a second time with ``-fmad=false`` (``STD_TL``) and ``bw_probe.cu``
   (one build per probe mix of phase 16) with nvcc from the checkout's
   sources, all builds started together; print the build time and ptxas'
   registers and spills per kernel entry, and for the fused kernel, whose
   ptxas count is the launch count, each warpgroup role's registers and
   local-memory spills read from its region of the SASS.  Under the nvcc
   release they were recorded with, the SASS of every library in
   ``EXACT_SASS`` must equal its digest there; the others' digests are
   printed.
3. NL kernel against its plain PyTorch version on the card, on the same
   inputs: the 100-column fixture and a ragged 5,000-column expansion,
   f32 and f64, ldrain1d off and on; then the main path's own shapes
   (163,840 columns f32 and 16,384 f64, ldrain1d off) on inputs built by
   ``Cloudsc2State.device_kernel_inputs`` as the CLI builds them; max
   |kernel - plain| over the field's max |plain| within 1e-12 (f64) and
   5e-6 (f32).  In each case the tropopause eta of ``kernel_prelude`` (the
   prelude's kernel, ``csrc/cloudsc2_prelude.cu``) equals the plain
   expression's on the same card tensors bit for bit.  Then one line: the
   f64 NL sweep's registers, local bytes and blocks per SM as its span's
   counters read them (``build.occupancy``), beside ptxas' spills.
4. Main path through the CLI entry point on ``cuda``:
   ``nl 1 163840 128 --dtype f32 --threshold 10000 --kernels`` and
   ``nl 1 16384 128 --dtype f64 --kernels``, both validating against the
   golden file (the stream contract, assembled once after the timed loop);
   the kernel's launch counter, zeroed just before, must show that both
   ran through the kernel, and the prelude's counter that every call
   launched the prelude's kernel; then ``nl 1 16384 128 --dtype f64``, the
   truth path, against the same golden file.
5. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the kernel, the pre-kernel work (one launch of the prelude's kernel,
   its tropopause eta held bit for bit to the plain expression's on each
   input set, and the plain expression timed beside it), the whole
   ``run_nl`` call on
   the stream contract, the output contract's assembly (the launch of
   ``csrc/cloudsc2_contract.cu``: ``unblock_outputs`` of the stream
   contract's outputs, the copy form, paid once where a caller validates;
   in place, as the standard paths run it, with and without the seeds; each
   held bit for bit to the PyTorch expressions ``plain_contract``, timed
   beside them), ``run_nl(backend="kernels")`` on
   transposed views, and the plain version, with the bytes the sweep must
   move and the attained bandwidth.
6. TL and AD kernels against their plain versions on the card: 100 and a
   ragged 5,000 columns, f32 and f64, ldrain1d off and on, the TL kernel
   with and without its primal streams; then the TL+AD path's own shapes
   (163,840 columns f32, 16,384 f64) on inputs built by
   ``device_kernel_inputs(..., pqs=True)``; within 1e-11 (f64) and, f32,
   1e-5 (TL) and 1e-4 (AD, whose plu adjoint carries f32 rounding of that
   size: PERF.md).
7. TL+AD main path through the CLI entry point on ``cuda``:
   ``tlad 1 163840 128 --dtype f32 --kernels`` and ``tlad 1 16384 128
   --dtype f64 --kernels``,
   each passing the adjoint identity within the JAX package's budgets; both
   kernels' launch counters, zeroed just before, must show that they ran,
   and the prelude's that every call launched the prelude's kernel.
8. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the TL kernel with and without primal streams, the AD kernel, the whole
   ``run_tlad`` call and the plain unit (one call, not warmed up, as for
   every plain version from here on), with each kernel's bytes and attained
   bandwidth.

9. The checkpointing forward kernel and the streamed-increment TL kernel
   (the drop-ins' sweeps) and the standard contract's TL (``STD_TL``, the
   unit's: primal, tangents and checkpoints) against their plain versions
   on the card: 100 and a ragged 5,000 columns, f32 and f64, ldrain1d off
   and on, the TLs with lregcl off and on, pqs perturbed by up to 1% away
   from SATUR in the ragged f64 cases; the AD kernel with lregcl off and
   unfolded seeds likewise; the forward kernel against both in-register
   TLs' own checkpoints and primal streams; then the standalone paths'
   shapes (163,840 columns f32, 16,384 f64; the standard TL with lregcl
   on). Tolerances as in 3 and 6.
10. The standalone TL and AD paths through the CLI entry point on
   ``cuda``: ``tl 1 16384 128 --dtype f64 --kernels`` (Taylor test on the
   truth path, then the f32 parity of the TL kernel) and ``ad 1 16384 128
   --dtype f64 --kernels`` (adjoint test, then the f32 identity through the
   kernels), and ``measure_f32_verdicts`` at 163,840 f32 columns, whose
   unit (``run_tlad(backend="kernels")``) runs the standard contract's TL
   (increments in registers, built with ``-fmad=false``) and the AD from
   its checkpoints; the launch counters, zeroed just before, must show
   that those two kernels ran and that the forward-checkpoint and
   streamed-increment kernels did not.  Also printed: how far the TL kernel and the
   truth path, both f32, sit from the truth path in f64; and the JAX
   package's f32 TL parity, 1e-6, held by the streamed-increment TL kernel
   (shipped built with ``-fmad=false``) at 16,384 columns with ``lregcl``
   off and on.
11. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the standard contract's TL (record ``cloudsc2_tl_std``, with phase
   10's launches and verdicts), the forward and streamed-increment TL
   kernels (the drop-ins' records, with phase 9's launches), the
   standard-contract ``run_tlad`` on ``(ncol, nlev)``-contiguous inputs
   (with its transposes) and on transposed views of levels-major inputs
   (without), and the plain versions once.
12. The encoded TL kernel, the encoded AD kernel and the fused TL+AD kernel
   against their plain versions on the card, f32: 100 columns with
   ldrain1d off and on, a ragged 5,000, and an odd 5,001 (int16 rows then
   start on odd half-words) with ldrain1d on, the encoded TL with and
   without its primal streams, each encoded kernel for the default encoding
   (whose mask has a kernel of its own) and for one that keeps pt and pmfu
   f32 too, and equal bit for bit to the exact kernels on the decoded
   inputs; the fused kernel also in f64 (100 columns
   with ldrain1d on, 5,001 with it off); then the harness's own shape,
   163,840 f32 columns (16,384 f64 for the fused kernel), and the fused
   kernel's four ``lregcl``-off variants at 100 columns.  Tolerances as in
   6.  The fused kernel is also held against the two-kernel unit on the
   same inputs, bit for bit in f32 with ldrain1d off, and the adjoint identity is
   checked through the encoded pair (with dx = DSCALE x the decoded inputs)
   and through the fused unit.
13. The harness as its users run it: ``kernel_ab.main(["two", "noprim",
   "fused", "enc", "encnp", "two"])`` at 327,680 f32 columns; the launch
   counters of the TL, AD, fused, encoded TL and encoded AD kernels, zeroed
   just before, must equal the units each config ran (warm-up and reps).
14. Timing with CUDA events at 327,680 columns f32 over distinct inputs:
   the fused kernel, the encoded TL kernel with and without primal
   streams, the encoded AD kernel, each with its bytes and attained
   bandwidth, and the plain versions once; the fused record carries its
   launch plan (split, budgets, ring, grid, scratch) and role registers.

15. The encoded NL kernel, the resident NL kernel against their plain
   versions on the card.  Encoded (f32): 100 columns with every combination
   of ``fuse_satur``, ``keep_f32`` (default, ``("pq",)``, all names, none) and
   payload (int16, bfloat16); then 100 columns with ldrain1d on, a ragged
   5,000, an odd 5,001 with ldrain1d on and 163,840 columns over seven of the
   combinations (the default keep in both stream orders, whose masks have
   kernels of their own, and five that run the runtime-mask kernel); each
   case prints which kernel ran; 2e-5 of the field's max against the plain
   version on the decoded trajectory (``ENC_NL_TOLERANCE`` says why), bit for
   bit against the exact kernel (pqs computed) or the forward-checkpoint
   kernel (pqs streamed) launched on the same decoded inputs, and, printed,
   the distance to the exact sweep by the JAX test's metric (sum|a-b|/sum|b|,
   below 5e-4 for int16).  Resident: 100
   columns f32 and f64 with ldrain1d off and on, 5,000 f32, 5,001 f64, at
   the default ring, at a ring whose depth does not divide the levels, and
   with every level on chip first (``depth = nlev`` at the widest block
   that fits); then 163,840 f32 and 16,384 f64; 5e-6 / 1e-12, and held
   against the forward-checkpoint kernel's outputs on the same inputs.
16. The paths as their users run them, launch counters zeroed before and
   asserted exactly after: ``bw_probe.main`` for the plain stream (256 MiB
   arrays) and, at 327,680 columns, the window mixes of the port's own
   kernels (NL 15x8, forward-checkpoint 16x11, TL 16x19, streamed TL 32x16,
   AD 27x16 reversed, each plain and compute-weighted; resident 16x8 and
   fused 16x32 plain), each of which first holds the probe's kernel against
   its plain version forward and reversed; ``encoding_study.main`` on the
   card; and the encoded and resident NL sweeps through their wrappers at
   327,680 f32 columns.
17. Timing with CUDA events at 327,680 columns f32 over distinct inputs, in
   this order: exact NL, encoded (default keep), encoded ``("pq",)``,
   encoded bfloat16, the all-f32 control (each labelled with the kernel it
   ran, fixed or runtime mask), resident at the default ring, at
   128 columns x 8 levels and with every level resident, exact NL again (a
   drift control); each with its bytes, attained bandwidth, bound, registers
   and spills; one encoding's time and the plain versions once at 163,840
   columns; then the probe's 15x8 mix as the one PyTorch call that computes
   it (``torch._foreach_add`` over the 8 outputs), between two timings of the
   probe's kernel on the same arrays (``library_ms``).
18. Chunked streaming and the bench.  ``run_chunked`` through the kernels
   against the same chunks through the plain versions on the card (16,384
   f32 columns in two chunks; relative to the checksum 5e-6 for ``nl``,
   1e-4 for ``tlad``), in a comparison process of its own; then, launch
   counters zeroed before and asserted exactly after, the main path:
   ``run_chunked`` of ``nl`` and ``tlad`` over 655,360 columns in chunks of
   163,840 and 327,680 (the checksums within 1e-5 and 1e-4 of each other);
   ``fused_gen`` equal bit for bit to regeneration over two chunks of a
   whole period; the chunk loop (``drivers.chunk_loop``) under
   ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
   that synchronises with the host, its one read after, equal bit for bit
   to the same run outside it; ``python -m cloudsc2jax_torch.bench`` for
   ``nl``, ``tlad``, ``chunked`` and ``chunked_tlad`` at their defaults,
   each in a process of its own, each record printed, the chunked ones
   failing unless ``streamed_gb > device_memory_gb > peak_allocated_gb``;
   and ``nl 1 100 100 --kernels --dtype f64 --profile
   build/chip_smoke/profile`` with ``CLOUDSC2_WRITE_REFERENCE=1`` in a
   temporary directory, whose trace must name ``cloudsc2_nl_kernel`` and
   whose ``reference.npz`` must validate a second run at the default
   threshold.
19. The column decomposition over processes: two ranks on the card, each a
   process of its own (``chip_smoke.py --rank-worker``) in one ``gloo``
   group over ``localhost``, started after phase 2's build so that they find
   the libraries built.  Each rank, its launch counters zeroed just before
   each run and read just after, drives the CLI with
   ``CLOUDSC2_NUM_PROCESSES=2``: ``nl 1 327680 128 --dtype f32 --threshold
   10000 --kernels --repeat 10`` (golden validation reduced over the ranks)
   and ``tlad 1 327680 128 --dtype f32 --kernels --repeat 10`` (adjoint
   identity reduced over the ranks), each
   of which must pass on both ranks with the kernels launched on both; then
   ``run_chunked(mesh=)`` of ``nl`` and ``tlad`` over 655,360 columns in
   chunks of 327,680, its chunk loop under
   ``torch.cuda.set_sync_debug_mode("error")`` and its one reduction over
   the ranks after it, both ranks' checksums within 1e-5 and 1e-4 of phase
   18's one-process checksum of the same columns.  The main process runs
   the same two CLI runs as one process (the same verdicts) and
   ``dist.dryrun(1)``, and prints each rank's ms from rank 0's gathered
   table and the two ranks' combined columns/s: two processes time-slice
   one card, so that is no scaling.
20. The modules of the last slice.  In a process of its own beside phases
   3-10 (host-bound): (a) the truth path's ``run_tlad(backend="truth")`` at
   16,384 f64 columns with ``remat=False``, ``remat=True`` and ``remat=True,
   nproma=4096``, each run's wall seconds and ``max_memory_allocated``, the
   three equal within 1e-12 of each field's max and the checkpointed peak
   below the stored one; (b) the CLI's truth route ``tlad 1 16384 4096
   --dtype f64`` (4 NPROMA blocks: each block costs the host a whole unit's
   launches, so the 128 blocks of ``nproma`` 128 would take half an hour),
   rc 0; (c) the bench's ``CLOUDSC2_BENCH_PALLAS=0`` records for ``nl`` and
   ``tlad`` at 16,384 columns, 2 repeats, each in a process of its own
   (``chip_smoke.py --bench-worker``) that launches no kernel.  Then in the
   main process: the bench's ``MODE=resident`` and ``LAYOUT=standard`` records
   at their defaults, each of which must launch its kernel (#2, #1); (d)
   ``roofline.py``'s bound of every kernel of the records, whose bytes each
   timing phase has held to ``_nbytes`` of its run's tensors, with the
   attained GB/s and the shares of the bound and of the probe's ceiling; (e)
   the native shim, built with g++, ``sched_getcpu() >= 0``; (f)
   ``python -m cloudsc2jax_torch.onchip_evidence --list`` and its
   ``probe_stream`` step.  Each time and memory figure is printed beside the
   card's name and power limit.
21. The schedules JAX keeps beside the shipped ones.  In a comparison
   process of its own, at 100, 5,001 and 327,680 columns (f32, and f64 at
   100 and 5,001): the 17-stream AD kernel's streams assembled by
   ``assemble_shifted_adjoints`` equal to the in-place AD kernel's adjoints
   bit for bit; the chunked TL, streamed-increment TL, forward-checkpoint
   and 17-stream AD kernels at C = 2, 3, 4 equal to their one-level kernels
   bit for bit (else the worst output's distance is printed and held at the
   plain-version tolerance); the encoded TL and AD on bfloat16 encodings
   (the default one and one read through the runtime mask) equal to the
   exact kernels on the decoded inputs bit for bit; at 5,001 f32 and 100 f64
   columns every new kernel against its plain version (the tolerances of 3
   and 6, and ``BF16_TOLERANCE`` for the bfloat16 TL); then every kernel
   library, the new ones at each C, launched twice on the same inputs must
   give the same bits.  In the main process, after phase 19, launch counters
   zeroed before and asserted exactly after: ``kernel_ab`` with ``noprim
   xscatnp two xscat chunk:2 chunk:3 chunk:4`` at 327,680 f32 columns, the
   standard contract assembled from ``kernels.schedules``' chunked sweeps at
   each C against its drop-ins ``cloudsc2_kernel_tl``/``_ad`` (16,384 f32
   columns, bit for bit one level a step), and the encoded TL and AD on a
   bfloat16 encoding through their wrappers with the adjoint identity; then
   each new kernel's time at 327,680 f32 columns by CUDA events beside the
   kernel it reschedules in the same run, with its bound, ptxas registers
   and spills (per C), and, like every record, its window-matched ceiling
   (the 17-stream AD's at 27 reads x 17 writes reversed, a probe mix of
   phase 16).

The comparisons of phases 6, 9, 12, 15, 18 and 21 and phase 20's truth path
are bound by the host, so each runs in a process of its own (``chip_smoke.py --compare <name>``, started
after the build) beside phases 3, 4, 7 and 10 of the main process; the
timing phases start when all of them have ended, and the script stops any
that is left if it fails.  A comparison's output goes to
``build/chip_smoke/<name>.log`` and its result to ``<name>.json`` beside it.
Each comparison also times the plain versions once, not warmed up, at
163,840 f32 columns (5,001 in phase 21; ``plain_ms``, ``plain_ncol``): a
plain sweep takes seconds of host time at any size and is no yardstick of
speed.
``python3 chip_smoke.py --serial`` runs the same phases in one process, to
measure what the fan-out saves (PERF.md has both times).

Each kernel's record holds its time beside its bound
(:mod:`cloudsc2jax_torch.roofline`): the larger of the bytes it must move
(every input read once, every output written once; held equal to the bytes
of this run's tensors) over the card's published memory rate, and its
operations (statements of its level body per level and column) over the
card's published f32 rate.  No single PyTorch call computes one of the
level-recurrent sweeps, so their ``library_ms`` is null; the probe's is
phase 17's ``torch._foreach_add``.  ``ceiling_ms``
is the time the window-matched probe of phase 16 would take for the kernel's
bytes at the kernel's own mix of reads and writes per level.  The prelude's
record comes last: its bytes are the rows of the eta band's hull it reads
(``tropopause_hull``: pt and ten_t, and ceta's band levels) and the
tropopause eta it writes, held to the run's own tensors; its
``library_ms`` is the plain expression ``tropopause_eta_lm`` on the same
inputs; it has no probe mix, so no ``ceiling_ms``.  So does the contract's
(``cloudsc2_contract``, in place, no seeds, as ``run_nl(backend="kernels")``
runs it): its bytes are the flux rows read and the top rows and enthalpy
fluxes written (``contract_bytes``), held to the run's tensors; its
``library_ms`` the PyTorch expressions ``plain_contract`` on the same
streams.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
LIBRARIES = ("cloudsc2_nl", "cloudsc2_tl", "cloudsc2_tl_din", "cloudsc2_ad",
             "cloudsc2_tl_enc", "cloudsc2_ad_enc", "cloudsc2_tlad_fused",
             "cloudsc2_nl_enc", "cloudsc2_nl_res", "bw_probe",
             "cloudsc2_ad_xscat", "cloudsc2_ad_chunk", "cloudsc2_tl_chunk",
             "cloudsc2_tl_din_chunk", "cloudsc2_fwd_chunk", "cloudsc2_tl_enc_bf16",
             "cloudsc2_ad_enc_bf16", "cloudsc2_prelude", "cloudsc2_contract")
# the standard contract's TL (tlad_kernel.launch_cloudsc2_tl_std): the build
# of cloudsc2_tl.cu with build.NO_FMA, beside its default build
STD_TL = ("cloudsc2_tl", (), ("-fmad=false",))
CSRC = ROOT / "cloudsc2jax_torch" / "csrc"

TOLERANCE = {"float32": 5e-6, "float64": 1e-12}
# The encoded NL kernel against its plain version.  Its outputs equal the
# exact kernel's on the decoded inputs bit for bit, so nothing of this is the
# encoded build's (its register cap, its spills); the decoded trajectories
# are worse conditioned than the exact one (an int16 pqs no longer is SATUR of
# the decoded pt): the worst case, tenl_t at 100 columns with pqs streamed,
# reads 4.712e-6 with and without FMA contraction while f32 rounding alone
# moves the plain version 5.0e-6 from its f64 self there
# (cloudsc2jax_torch/probes/nl_enc_fmad.py, NVIDIA H100; PERF.md)
ENC_NL_TOLERANCE = 2e-5
TLAD_TOLERANCE = {"tl": {"float32": 1e-5, "float64": 1e-11},
                  "ad": {"float32": 1e-4, "float64": 1e-11}}
TIMING_NCOL = 327_680
MAIN_PATH_RUNS = (
    ["nl", "1", "163840", "128", "--dtype", "f32", "--threshold", "10000",
     "--kernels"],
    ["nl", "1", "16384", "128", "--dtype", "f64", "--kernels"],
)
# the NL truth path through the CLI, against the same golden file
TRUTH_RUNS = (["nl", "1", "16384", "128", "--dtype", "f64"],)
# (ncol, dtype, ldrain1d) of the sweeps on the CLI's main paths, for the
# kernel-against-plain comparisons of the NL, TL+AD and standalone phases
COMPARE_SHAPES = [(163840, "float32", False), (16384, "float64", False)]
# (ncol, dtype, ldrain1d) of the small comparisons of the TL and AD phases:
# one block and a ragged grid, both dtypes, both evaporation settings
SMALL_CASES = [(ncol, name, ldrain1d)
               for ncol in (100, 5000)
               for name in ("float32", "float64")
               for ldrain1d in (False, True)]
TLAD_RUNS = (
    ["tlad", "1", "163840", "128", "--dtype", "f32", "--kernels"],
    ["tlad", "1", "16384", "128", "--dtype", "f64", "--kernels"],
)
TEST_RUNS = (
    ["tl", "1", "16384", "128", "--dtype", "f64", "--kernels"],
    ["ad", "1", "16384", "128", "--dtype", "f64", "--kernels"],
)
VERDICT_NCOL = 163_840
AB_CONFIGS = ["two", "noprim", "fused", "enc", "encnp", "two"]
# keep_f32 of the encoded TL and AD comparisons of phase 12: the default
# encoding (its mask has a kernel of its own) and one whose mask the kernels
# read at run time
ENC_TLAD_KEEPS = (("pq", "plu", "paph"), ("pq", "plu", "paph", "pt", "pmfu"))
# (ncol, dtype) of the harness's shape in the comparisons of phase 12
AB_SHAPES = ((163840, "float32"), (16384, "float64"))
# the mix each kernel is judged against
KERNEL_MIX = {
    "cloudsc2_nl": "nl", "cloudsc2_nl_enc": "nl", "bw_probe": "nl",
    "cloudsc2_nl_res": "res", "cloudsc2_fwd_ckpt": "fwd", "cloudsc2_tl": "tl",
    "cloudsc2_tl_enc": "tl", "cloudsc2_tl_din": "din", "cloudsc2_tl_std": "tl",
    "cloudsc2_ad": "ad",
    "cloudsc2_ad_enc": "ad", "cloudsc2_tlad_fused": "fused",
    "cloudsc2_ad_xscat": "xscat", "cloudsc2_ad_chunk": "xscat",
    "cloudsc2_tl_chunk": "tl", "cloudsc2_tl_din_chunk": "din",
    "cloudsc2_fwd_chunk": "fwd", "cloudsc2_tl_enc_bf16": "tl",
    "cloudsc2_ad_enc_bf16": "ad",
}
# (fuse_satur, keep_f32 label, payload) of the encoded NL comparisons past
# the first case, which runs every combination
ENC_SUBSET = ((True, "default", "int16"), (False, "pq", "int16"),
              (True, "all", "int16"), (False, "none", "int16"),
              (True, "pq", "bfloat16"), (False, "default", "bfloat16"),
              (False, "default", "int16"))
ENC_KEEPS = ("default", "pq", "all", "none")
ENC_L1_BUDGET = 5e-4  # tests/test_pallas.py:150-154, int16 payloads
# dynamic shared memory a block may opt into on an H100 (227 KB)
RESIDENT_LIMIT_BYTES = 232_448
# columns at which phase 17 times the new kernels' plain versions
PLAIN_NCOL = 163_840
# phase 18: run_chunked against its plain versions (columns, chunk, in
# 128-column groups) and its tolerance relative to the checksum, those of
# the kernels against their plain versions; the main path's columns and
# chunk sizes and the invariance between them (the JAX package's own for
# its decompositions, tests/test_dist.py); the bench's variants; the CLI
# run that profiles and writes a golden file
CHUNK_COMPARE = (16_384, 8_192)
CHUNK_TOLERANCE = {"nl": 5e-6, "tlad": 1e-4}
CHUNK_NGPTOT = 655_360
CHUNK_SIZES = (163_840, 327_680)
CHUNK_INVARIANCE_RTOL = {"nl": 1e-5, "tlad": 1e-4}
# phase 19: the ranks, their CLI runs (each rank expands and validates its
# half of the columns) and the time each rank's process may take
MP_RANKS = 2
MP_RUNS = (
    ["nl", "1", "327680", "128", "--dtype", "f32", "--threshold", "10000",
     "--kernels", "--repeat", "10"],
    ["tlad", "1", "327680", "128", "--dtype", "f32", "--kernels", "--repeat", "10"],
)
MP_TIMEOUT_S = 300
BENCH_VARIANTS = ("nl", "tlad", "chunked", "chunked_tlad")
PROFILE_RUN = ["nl", "1", "100", "100", "--kernels", "--dtype", "f64"]
# phase 20: the truth path's TL+AD unit at the f64 size of the tl and ad
# dwarfs, whole and in NPROMA blocks (each block costs the host a whole
# unit's launches, so 4 blocks, not the 128 of nproma 128), against each
# other within TRUTH_TOLERANCE of each field's max; the CLI's truth route
# in the same blocks; the bench's truth records at the same size
TRUTH_NCOL = 16_384
TRUTH_NPROMA = 4_096
TRUTH_TOLERANCE = 1e-12
TRUTH_CLI_RUN = ["tlad", "1", str(TRUTH_NCOL), str(TRUTH_NPROMA), "--dtype", "f64"]
TRUTH_BENCH = {"CLOUDSC2_BENCH_PALLAS": "0", "CLOUDSC2_BENCH_NGPTOT": str(TRUTH_NCOL),
               "CLOUDSC2_BENCH_REPEATS": "2", "CLOUDSC2_BENCH_F32_CHECKS": "0"}
# the bench's kernel modes of phase 20, at their defaults
BENCH_MODES = ({"CLOUDSC2_BENCH_MODE": "resident"},
               {"CLOUDSC2_BENCH_LAYOUT": "standard"})
# phase 21: (ncol, dtype, ldrain1d, lregcl, fold_seeds, plain) of the
# schedules' comparisons, plain saying whether the kernels are also held to
# their plain versions there (at 5,001 and 100 columns: a plain sweep costs
# the host seconds at any width); the levels a step the chunked libraries
# are built for; the kernel families of the records; kernel_ab's configs of
# the schedules; the columns of the standard contract at each C
SCHEDULE_CASES = ((100, "float32", True, True, True, False),
                  (100, "float64", True, False, False, True),
                  (5001, "float32", False, True, True, True),
                  (5001, "float64", False, True, True, False),
                  (TIMING_NCOL, "float32", False, True, True, False))
SCHEDULE_PLAIN_NCOL = 5001
CHUNK_LEVELS_RUN = (2, 3, 4)
SCHEDULE_KINDS = ("xscat", "ad_chunk", "tl_chunk", "din_chunk", "fwd_chunk",
                  "tl_bf16", "ad_bf16")
SCHEDULE_AB = ["noprim", "xscatnp", "two", "xscat", "chunk:2", "chunk:3", "chunk:4"]
STD_CHUNK_NCOL = 16_384
# The bfloat16 encoded TL against its plain version: the AD's 1e-4.  The
# payloads keep 8 significant bits, and on the decoded trajectory the cloud
# cover 1 - sqrt(ratio) can take ratio from a difference at ~6e-4 of its
# terms' size, where two f32 evaluations of one level body move pclc and the
# covptot checkpoint by 3.3e-5 of their maximum (tests/test_torch_schedules.py
# sees it between the JAX package and the plain version on the CPU); the
# kernels equal the exact kernels on the decoded inputs bit for bit besides
BF16_TOLERANCE = 1e-4
# The code of every library but the encoded NL one (#1-#5, #7, #8, #9 and
# the window probe at its NL mix): per library, build.library_digest of the
# SASS of its entries, recorded on an NVIDIA H100 under the nvcc release
# named, #8 and #9 from the tree before the encoded NL kernel took their load
# policy (cloudsc2jax_torch/probes/nl_enc_ab.py), the others from the tree
# before #8 and #9 were redesigned (probes/enc_ab.py), but the
# streamed-increment TL's, which is its build with -fmad=false
# (probes/din_fmad_ab.py; its contracted build is ab85341a...); the seven
# libraries of the schedules (phase 21: the 17-stream AD, the chunked sweeps,
# the bfloat16 encoded sweeps) as first built, on the same card and release;
# and the standard contract's TL, STD_TL, keyed by its name and flags, as
# first built; the six libraries that include the AD level body
# (cloudsc2_ad_level.cuh) as rebuilt when it came to divide once per divisor
# (probes/level_ab.py ad, against the tree before); the eight builds that
# include the TL level body (cloudsc2_tl_level.cuh: cloudsc2_tl in both
# builds, _tl_din, _tl_chunk, _tl_din_chunk, _tl_enc, _tl_enc_bf16,
# _tlad_fused) as rebuilt when it too came to divide once per divisor
# (probes/level_ab.py tl, against the tree before).
# Phase 2 fails if a build differs under that release; under another release
# it says that it did not check.
EXACT_SASS_RELEASE = "release 12.9, V12.9.86"
EXACT_SASS = {
    "cloudsc2_nl":
        "b2c4a9637915d6568094fc4306ec116494c72ef31eafd672e5f1f43025f7af60",
    "cloudsc2_nl_res":
        "4b38e00514a94c1f16680fd404533d0e6a179384878723d990d173ca1ddd4154",
    "cloudsc2_tl":
        "dd020d5c979766baa468e20300abf4109d7572c92c7b41a7b2c9e33350367375",
    "cloudsc2_tl_din":
        "94f772f2743bad7a1ad46ab210755e532c33e826af534017aa2dcd650b091ffa",
    "cloudsc2_tl -fmad=false":
        "637e39665d2630c721765b4c0cd544fcc0dfb8a0e774ea677fc2d081ef1a6748",
    "cloudsc2_ad":
        "7b2e800b012438d35f6401ec4c5c87eb365bd6ae476d8a50c15facc9a3bdb54a",
    "cloudsc2_tlad_fused":
        "22ab965c887acb19a21c41df2b9e6fc088685ae4b3a65a608d0a6932de4487f8",
    "cloudsc2_tl_enc":
        "bbc3687e5538d17d423191261e3635f4a07fd217ef33df3f1165be5bdcfcc33c",
    "cloudsc2_ad_enc":
        "726a3dedaab2e1ae05aef423cea4e23d3cd9720074f95f5bf5c4e895e6434aaa",
    "bw_probe BW_PROBE_R=15 BW_PROBE_W=8 BW_PROBE_TANH=0 BW_PROBE_FLOPS=0":
        "1135bc6ea617882236b667ce6bdb0c9e881a9697576534d37b240de51c1321cc",
    "cloudsc2_ad_xscat":
        "78ce2f29eddc72c332eb0e4dbb71a4cbcc2f3d8edb8bd9fd70df97c4cb8e0977",
    "cloudsc2_ad_chunk":
        "02b998ea9179c26d3b02c8e26f85ff51d493c61de916a083da385754172e3ecf",
    "cloudsc2_tl_chunk":
        "78b594082d9b921658b6ddf784a43c89fd16e12754b184deb841c6ad9940a007",
    "cloudsc2_tl_din_chunk":
        "8e592dcd4db8f8f0561fae32b510e4cf8050d44a358ba1861b9e86f6aac03925",
    "cloudsc2_fwd_chunk":
        "7195fb9cead6541ff8b488df8f5503c6a5d6494d76a5d4eb00fc40fc34123a67",
    "cloudsc2_tl_enc_bf16":
        "4135d4bc0262c10bfb935ec6f0bc60fe51b879c103182e690ea3e7a587ee6d33",
    "cloudsc2_ad_enc_bf16":
        "ce444d939dfa6fb827a6ea79dfb5cd64d7ef5c63885bcb7d6a90696d6d81b252",
}


def _nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _max_rel_err(got, ref):
    """Worst field of max |got - ref| / max |ref|, and the worst absolute
    difference."""
    rel = absolute = 0.0
    for a, b in zip(got, ref):
        d = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-30)
        rel = max(rel, d / scale)
        absolute = max(absolute, d)
    return rel, absolute


def _nbytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (nested tuples; None skipped)."""
    total = 0
    for t in trees:
        if t is None:
            continue
        if hasattr(t, "numel"):
            total += t.numel() * t.element_size()
        else:
            total += _nbytes(*t)
    return total


def _bound(name: str, ncol: int, nlev: int, moved: int) -> dict:
    """The least time the card could take for kernel ``name``'s work at
    ``ncol`` f32 columns (``roofline.bound``: bytes over the card's memory
    rate or operations over its f32 rate, whichever is larger), its bytes
    held to ``moved``, the bytes of this run's own tensors."""
    from cloudsc2jax_torch import roofline

    b = roofline.bound(name, ncol, nlev)
    if b["bytes"] != moved:
        raise AssertionError(f"{name}: roofline counts {b['bytes']} bytes, the "
                             f"run's tensors {moved}")
    return {**b, "library_ms": None}


def _time_ms(fn, args_list, calls: int) -> float:
    """Mean device time per call over ``calls`` calls cycling through
    ``args_list``, after one warm call per argument set."""
    import torch

    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def _time_once_ms(fn, *args) -> float:
    """Device time of one call, not warmed up: for the plain versions, whose
    sweeps take seconds of host time and are no yardstick of speed."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _timed(fn, *args):
    """``fn(*args)`` and its device time in ms, not warmed up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    value = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return value, start.elapsed_time(stop)


def _lap(phases: str, since: float) -> float:
    now = time.perf_counter()
    print(f"phases {phases}: {now - since:.1f} s")
    return now


def _check(what: str, got, ref, tol: float, worst: dict, name: str) -> None:
    import torch

    rel, absolute = _max_rel_err(got, ref)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    print(f"    {what}: max rel err {rel:.3e} (tol {tol:g}), max abs err "
          f"{absolute:.3e}, finite={finite}")
    if not finite or not rel <= tol:
        raise AssertionError(f"{what} disagrees with the plain version")
    worst[name] = max(worst.get(name, 0.0), rel)
    worst["abs"] = max(worst.get("abs", 0.0), absolute)


def compare_tlad(state, params):
    """Phase 6: the TL and AD kernels against their plain versions on the
    card.  Returns the worst errors and the plain versions' times."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_reference,
    )

    plain_ms = {}
    # -- 6. TL and AD kernels against their plain versions on the card
    worst = {"tl": {}, "ad": {}}
    tl0, ad0 = cloudsc2_tl.launches, cloudsc2_ad.launches
    cases = SMALL_CASES + COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        print(f"[6] ncol={ncol} {name} ldrain1d={ldrain1d}:")
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        kw = dict(dscale=DSCALE, ldrain1d=ldrain1d)
        out, dout, ckpts = cloudsc2_tl(inputs, params, **kw)
        none, dout_n, ckpts_n = cloudsc2_tl(inputs, params, write_primal=False, **kw)
        (r_out, r_dout, r_ckpts), t_tl = _timed(
            lambda: cloudsc2_tl_reference(inputs, params, **kw))
        adj = cloudsc2_ad(inputs, r_dout, r_ckpts, params, ldrain1d=ldrain1d)
        r_adj, t_ad = _timed(lambda: cloudsc2_ad_reference(
            inputs, r_dout, r_ckpts, params, ldrain1d=ldrain1d))
        if (ncol, name) == (PLAIN_NCOL, "float32"):
            plain_ms.update(tl=t_tl, ad=t_ad)
        if none is not None:
            raise AssertionError("write_primal=False returned primal streams")
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        w_tl, w_ad = worst["tl"], worst["ad"]
        _check("TL primal", out, r_out, tol_tl, w_tl, name)
        _check("TL tangents", dout, r_dout, tol_tl, w_tl, name)
        _check("TL checkpoints", ckpts, r_ckpts, tol_tl, w_tl, name)
        _check("TL tangents, no primal", dout_n, r_dout, tol_tl, w_tl, name)
        _check("TL checkpoints, no primal", ckpts_n, r_ckpts, tol_tl, w_tl, name)
        _check("AD adjoints", adj, r_adj, tol_ad, w_ad, name)
        if ncol == 100 and name == "float32" and not ldrain1d:
            # how far f32 rounding alone moves the adjoints: the kernel and
            # the plain version, both f32, against the plain version in f64
            i64 = state.device_kernel_inputs(ncol, dtype=torch.float64,
                                             device="cuda", pqs=True)
            _, d64, c64 = cloudsc2_tl_reference(i64, params, **kw)
            a64 = cloudsc2_ad_reference(i64, d64, c64, params)
            for label, got in (("kernel f32", adj), ("plain f32", r_adj)):
                rel = {n: (g.double() - b).abs().max().item()
                       / max(b.abs().max().item(), 1e-300)
                       for n, g, b in zip(adj._fields, got, a64)}
                print(f"    AD {label} vs plain f64: max rel err "
                      f"{max(rel.values()):.3e} (plu {rel['plu']:.3e})")
    if (cloudsc2_tl.launches - tl0, cloudsc2_ad.launches - ad0) != \
            (2 * len(cases), len(cases)):
        raise AssertionError("the comparison did not launch the kernels")

    return {"worst": worst, "plain_ms": plain_ms}


def cli_tlad():
    """Phase 7: the TL+AD main path through the CLI entry point.  Returns
    the launches it made of the two kernels."""
    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    # -- 7. TL+AD main path through the CLI entry point
    cloudsc2_tl.launches = cloudsc2_ad.launches = kernel_prelude.launches = 0
    for argv in TLAD_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[7] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"TL+AD main path failed its check: {argv}")
    launches = {"tl": cloudsc2_tl.launches, "ad": cloudsc2_ad.launches,
                "prelude": kernel_prelude.launches}
    print(f"[7] kernel launches on the TL+AD main path: {launches}")
    if min(launches["tl"], launches["ad"]) < len(TLAD_RUNS):
        raise AssertionError("the TL+AD main path did not run through both kernels")
    if launches["prelude"] < launches["tl"]:
        raise AssertionError("the TL+AD main path did not run its prelude through "
                             "the prelude's kernel")

    return launches


def time_tlad(state, params, compared, launches):
    """Phase 8: timing at the headline size, f32, distinct inputs per call.
    Returns the two kernels' JSON records."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        launch_cloudsc2_ad,
        launch_cloudsc2_tl,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    # -- 8. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    tls = [launch_cloudsc2_tl(i, p, params, dscale=DSCALE)
           for i, p in zip(sets, pres)]
    ms = {
        "tl": _time_ms(lambda i, p: launch_cloudsc2_tl(i, p, params, dscale=DSCALE),
                       list(zip(sets, pres)), 20),
        "tl_noprim": _time_ms(
            lambda i, p: launch_cloudsc2_tl(i, p, params, dscale=DSCALE,
                                            write_primal=False),
            list(zip(sets, pres)), 20),
        "ad": _time_ms(lambda i, p, t: launch_cloudsc2_ad(i, p, t[1], t[2], params),
                       list(zip(sets, pres, tls)), 20),
        "run_tlad": _time_ms(lambda i: run_tlad(i, params), [(s,) for s in sets], 10),
    }
    plain["unit"] = plain["tl"] + plain["ad"]
    nlev = base.pt.shape[0]
    nbytes = {"tl": ((16 * nlev + 1) + 19 * nlev) * ncol * 4,
              "tl_noprim": ((16 * nlev + 1) + 11 * nlev) * ncol * 4,
              "ad": ((27 * nlev + 1) + (16 * nlev + 1)) * ncol * 4}
    for label, t in ms.items():
        line = f"[8] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in nbytes:
            line += (f", {nbytes[label] / 1e9:.4f} GB, "
                     f"{nbytes[label] / (t * 1e-3) / 1e9:.1f} GB/s")
        print(line + f" at {ncol} columns f32")
    for label, t in plain.items():
        print(f"[8] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 6")
    print(f"[8] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    bounds = {"tl": _bound("cloudsc2_tl", ncol, nlev,
                           _nbytes(sets[0], pres[0], tls[0])),
              "ad": _bound("cloudsc2_ad", ncol, nlev,
                           _nbytes(sets[0], pres[0], tls[0][1], tls[0][2])
                           + _nbytes(sets[0]))}

    def record(kind, replaces):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": f"cloudsc2_{kind}",
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/cloudsc2_{kind}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "max_rel_err_f64": w["float64"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": nbytes[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
        }

    tl_rec = record("tl", "cloudsc2jax/pallas/tlad_kernel.py:170")
    tl_rec.update(ms_noprim=ms["tl_noprim"], run_tlad_ms=ms["run_tlad"],
                  plain_unit_ms=plain["unit"])
    return [tl_rec, record("ad", "cloudsc2jax/pallas/tlad_kernel.py:454")]


def compare_variants(state, params):
    """Phase 9: the checkpointing forward kernel, the streamed-increment TL
    kernel (the drop-ins' sweeps), the standard contract's TL (``STD_TL``,
    the unit's) and the AD kernel's second instantiation against their plain
    versions on the card.  Returns the worst errors, the plain versions'
    times and the launches of each kernel."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_fwd_ckpt,
        cloudsc2_fwd_ckpt_reference,
    )
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_ad_reference,
        cloudsc2_tl,
        cloudsc2_tl_din,
        cloudsc2_tl_reference,
        cloudsc2_tl_std,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    def increments(inputs, gen):
        """Seeded increments of 0.5-1.5% of each input, not a multiple of it."""
        return Cloudsc2Inputs(*(
            DSCALE * x * (0.5 + torch.rand(x.shape, generator=gen,
                                           device=x.device, dtype=x.dtype))
            for x in inputs))

    plain_ms = {}
    # -- 9. the new kernels against their plain versions on the card
    worst = {"fwd": {}, "din": {}, "tl_std": {}, "ad": {}}
    counters = {"fwd": cloudsc2_fwd_ckpt, "din": cloudsc2_tl_din, "tl": cloudsc2_tl,
                "tl_std": cloudsc2_tl_std, "ad": cloudsc2_ad}
    before = {k: f.launches for k, f in counters.items()}
    expected = dict.fromkeys(counters, 0)
    cases = SMALL_CASES + COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        small = ncol <= 5000
        # f64 only: there the comparison stays at rounding level, while in
        # f32 the distance between a kernel and its plain version grows with
        # the conditioning of the perturbed trajectory (PERF.md section 6)
        perturbed = ncol == 5000 and name == "float64"
        print(f"[9] ncol={ncol} {name} ldrain1d={ldrain1d} "
              f"pqs {'perturbed' if perturbed else 'SATUR'}:")
        gen = torch.Generator(device="cuda").manual_seed(ncol)
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        if perturbed:
            inputs = inputs._replace(pqs=inputs.pqs * (0.99 + 0.02 * torch.rand(
                inputs.pqs.shape, generator=gen, device="cuda",
                dtype=inputs.pqs.dtype)))
        d_inputs = increments(inputs, gen)
        tol_nl = TOLERANCE[name]
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        out, ckpts = cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)
        (r_out, r_ckpts), t_fwd = _timed(lambda: cloudsc2_fwd_ckpt_reference(
            inputs, params, ldrain1d=ldrain1d))
        expected["fwd"] += 1
        _check("forward outputs", out, r_out, tol_nl, worst["fwd"], name)
        _check("forward checkpoints", ckpts, r_ckpts, tol_nl, worst["fwd"], name)
        # the TL kernel reads the same pqs: its checkpoints and primal
        # streams are the forward kernel's, up to the two bodies' rounding
        t_out, _, t_ckpts = cloudsc2_tl(inputs, params, dscale=DSCALE,
                                        ldrain1d=ldrain1d)
        expected["tl"] += 1
        _check("forward vs TL kernel", (*out, *ckpts), (*t_out, *t_ckpts),
               tol_nl if name == "float64" else tol_tl, {}, name)
        for lregcl in ((False, True) if small else (True,)):
            # the unit's TL: increments in registers, uncontracted, and the
            # checkpoints its reverse sweep reads in place of the forward's
            kw = dict(dscale=DSCALE, lregcl=lregcl, ldrain1d=ldrain1d)
            s_out, s_dout, s_ckpts = cloudsc2_tl_std(inputs, params, **kw)
            (rs_out, rs_dout, rs_ckpts), t_std = _timed(
                lambda: cloudsc2_tl_reference(inputs, params, **kw))
            if (ncol, name) == (PLAIN_NCOL, "float32"):
                plain_ms["tl_std"] = t_std
            expected["tl_std"] += 1
            what = f"standard TL lregcl={lregcl}"
            w = worst["tl_std"]
            _check(f"{what} primal", s_out, rs_out, tol_tl, w, name)
            _check(f"{what} tangents", s_dout, rs_dout, tol_tl, w, name)
            _check(f"{what} checkpoints", s_ckpts, rs_ckpts, tol_tl, w, name)
            _check(f"forward vs {what}", (*out, *ckpts), (*s_out, *s_ckpts),
                   tol_nl if name == "float64" else tol_tl, {}, name)
        for lregcl in ((False, True) if small else (False,)):
            kw = dict(lregcl=lregcl, ldrain1d=ldrain1d)
            p_out, p_dout = cloudsc2_tl_din(inputs, d_inputs, params, **kw)
            (rp_out, rp_dout, _), t_din = _timed(lambda: cloudsc2_tl_reference(
                inputs, params, d_inputs=d_inputs, **kw))
            if (ncol, name) == (PLAIN_NCOL, "float32"):
                plain_ms.update(fwd=t_fwd, din=t_din)
            expected["din"] += 1
            what = f"streamed TL lregcl={lregcl}"
            _check(f"{what} primal", p_out, rp_out, tol_tl, worst["din"], name)
            _check(f"{what} tangents", p_dout, rp_dout, tol_tl, worst["din"], name)
        if small:
            # the AD kernel's new instantiation: lregcl off, seeds as given
            adj = cloudsc2_ad(inputs, rp_dout, r_ckpts, params, lregcl=False,
                              ldrain1d=ldrain1d, fold_seeds=False)
            r_adj = cloudsc2_ad_reference(inputs, rp_dout, r_ckpts, params,
                                          lregcl=False, ldrain1d=ldrain1d,
                                          fold_seeds=False)
            expected["ad"] += 1
            _check("AD lregcl=False, unfolded seeds", adj, r_adj, tol_ad,
                   worst["ad"], name)
        torch.cuda.synchronize()
    if {k: f.launches - before[k] for k, f in counters.items()} != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs, d_inputs, out, ckpts, r_out, r_ckpts, t_out, t_ckpts
    del p_out, p_dout, rp_out, rp_dout, s_out, s_dout, s_ckpts, rs_out, rs_dout, rs_ckpts

    return {"worst": worst, "plain_ms": plain_ms, "launches": expected}


def cli_variants(state, params):
    """Phase 10: the standalone TL and AD paths through the CLI entry point
    and ``measure_f32_verdicts``.  Returns the kernels' launches, the
    verdicts and the f32 TL's distances to the f64 truth path."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_fwd_ckpt
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad,
        cloudsc2_tl_din,
        cloudsc2_tl_std,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.tlad import cloudsc2_tl as truth_tl

    # -- 10. the standalone TL and AD paths through the CLI entry point
    path = {"tl_std": cloudsc2_tl_std, "ad": cloudsc2_ad, "fwd": cloudsc2_fwd_ckpt,
            "din": cloudsc2_tl_din}
    for f in path.values():
        f.launches = 0
    for argv in TEST_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[10] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"standalone path failed its checks: {argv}")
    std = state.device_inputs(VERDICT_NCOL, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    verdicts = cli.measure_f32_verdicts(state, std, lregcl=True)
    print(f"[10] measure_f32_verdicts at {VERDICT_NCOL} f32 columns "
          f"({time.perf_counter() - t0:.1f} s): {verdicts}")
    if not (verdicts["finite"]
            and verdicts["tl_parity_rel_err"] < verdicts["tl_parity_tol"]
            and verdicts["ad_identity_rel_err"] < verdicts["ad_identity_tol"]):
        raise AssertionError("the f32 verdicts through the kernels failed")
    launches = {k: f.launches for k, f in path.items()}
    print(f"[10] kernel launches on the standalone TL and AD paths: {launches}")
    if min(launches["tl_std"], launches["ad"]) < len(TEST_RUNS) + 1:
        raise AssertionError("the standalone paths did not run through "
                             "every kernel")
    if launches["fwd"] or launches["din"]:
        raise AssertionError("the standard contract's unit ran the forward-checkpoint "
                             "or the streamed-increment sweep")
    # where the f32 parity's budget goes: the TL kernel and the truth path,
    # both f32, each against the truth path in f64 (exact TL, lregcl off)
    ncol = 16384
    i64 = state.device_inputs(ncol, dtype=torch.float64, device="cuda")
    i32 = Cloudsc2Inputs(*(x.float() for x in i64))
    _, d64 = truth_tl(i64, Cloudsc2Inputs(*(DSCALE * x for x in i64)), params)
    _, dk32, _ = run_tlad(i32, params, lregcl=False, backend="kernels")
    _, dt32 = truth_tl(i32, Cloudsc2Inputs(*(DSCALE * x for x in i32)), params)
    dist = {}
    for label, got, ref in (("kernel f32 vs truth f64", dk32, d64),
                            ("truth f32 vs truth f64", dt32, d64),
                            ("kernel f32 vs truth f32", dk32, dt32)):
        dist[label] = max(
            ((g.double() - r.double()).abs().max()
             / r.double().abs().max().clamp_min(1e-300)).item()
            for g, r in zip(got, ref))
        print(f"[10] TL tangents at {ncol} columns, {label}: max rel err "
              f"{dist[label]:.3e}")
    # the reference's 1e-6 TL parity, which the shipped streamed-increment
    # TL kernel (built without FMA contraction) holds with lregcl off and on
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_kernel_tl

    parity = {}
    d32 = Cloudsc2Inputs(*(DSCALE * x for x in i32))
    for lregcl in (False, True):
        _, dk = cloudsc2_kernel_tl(i32, d32, params, lregcl=lregcl)
        parity[f"lregcl={lregcl}"] = cli.tl_parity(i32, dk, params, lregcl=lregcl)
        print(f"[10] TL parity at {ncol} f32 columns, lregcl={lregcl}: "
              f"{parity[f'lregcl={lregcl}']:.3e} (tol {cli.PALLAS_TL_PARITY_TOL:g})")
    if not max(parity.values()) < cli.PALLAS_TL_PARITY_TOL:
        raise AssertionError("the streamed-increment TL kernel misses the "
                             "reference's TL parity")
    del i64, i32, d64, dk32, dt32, std, d32

    return {"launches": launches, "verdicts": verdicts, "dist": dist,
            "tl_parity": parity}


def time_variants(state, params, compared, ran, ad_record):
    """Phase 11: timing at the headline size, f32, distinct inputs per call.
    Returns the JSON records of the standard contract's TL (the unit's) and
    of the forward and the streamed-TL kernels (the drop-ins'), and adds the
    standalone paths' launches to the AD kernel's record."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        kernel_prelude,
        launch_cloudsc2_fwd_ckpt,
    )
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        launch_cloudsc2_tl_din,
        launch_cloudsc2_tl_std,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    launches, verdicts, dist = ran["launches"], ran["verdicts"], ran["dist"]
    # -- 11. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    dsets = [Cloudsc2Inputs(*(DSCALE * x for x in s)) for s in sets]
    views = [Cloudsc2Inputs(*(x.T for x in s)) for s in sets]
    ms = {
        "tl_std": _time_ms(
            lambda i, p: launch_cloudsc2_tl_std(i, p, params, dscale=DSCALE),
            list(zip(sets, pres)), 20),
        "fwd": _time_ms(lambda i, p: launch_cloudsc2_fwd_ckpt(i, p, params),
                        list(zip(sets, pres)), 20),
        "din": _time_ms(lambda i, d, p: launch_cloudsc2_tl_din(i, d, p, params),
                        list(zip(sets, dsets, pres)), 20),
        "run_tlad_kernels_views": _time_ms(
            lambda i: run_tlad(i, params, backend="kernels"),
            [(v,) for v in views], 10),
    }
    fwd0 = launch_cloudsc2_fwd_ckpt(sets[0], pres[0], params)
    din0 = launch_cloudsc2_tl_din(sets[0], dsets[0], pres[0], params)
    std0 = launch_cloudsc2_tl_std(sets[0], pres[0], params, dscale=DSCALE)
    nlev = base.pt.shape[0]
    bounds = {
        "tl_std": _bound("cloudsc2_tl_std", ncol, nlev, _nbytes(sets[0], pres[0], std0)),
        "fwd": _bound("cloudsc2_fwd_ckpt", ncol, nlev,
                      _nbytes(sets[0], pres[0], fwd0)),
        "din": _bound("cloudsc2_tl_din", ncol, nlev,
                      _nbytes(sets[0], pres[0], dsets[0], din0)),
    }
    del dsets, views, fwd0, din0, std0
    contiguous = [Cloudsc2Inputs(*(x.T.contiguous() for x in s)) for s in sets[:2]]
    ms["run_tlad_kernels"] = _time_ms(
        lambda i: run_tlad(i, params, backend="kernels"),
        [(c,) for c in contiguous], 6)
    for label, t in ms.items():
        line = f"[11] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in bounds:
            b = bounds[label]
            line += (f", {b['bytes'] / 1e9:.4f} GB, "
                     f"{b['bytes'] / (t * 1e-3) / 1e9:.1f} GB/s, bound "
                     f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
        print(line + f" at {ncol} columns f32")
    for label, t in plain.items():
        print(f"[11] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 9")
    print(f"[11] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    ad_record["launches_standalone_paths"] = launches["ad"]
    ad_record["max_rel_err_f32_lregcl_off"] = worst["ad"]["float32"]
    ad_record["max_rel_err_f64_lregcl_off"] = worst["ad"]["float64"]

    def record(kind, name, source, replaces, path, launched, **extra):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "path": path,
            "launches": launched,
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "max_rel_err_f64": w["float64"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": bounds[kind]["bytes"] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    # the unit's TL with phase 10's launches (the standard contract's verdicts
    # ran it); the drop-ins' sweeps with those of their comparison in phase 9
    ran_in_phase_9 = compared["launches"]
    return [
        record("tl_std", "cloudsc2_tl_std", "cloudsc2jax_torch/csrc/cloudsc2_tl.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:170",
               'run_tlad(backend="kernels")', launches["tl_std"],
               flags=" ".join(STD_TL[2]),
               run_tlad_kernels_ms=ms["run_tlad_kernels"],
               run_tlad_kernels_views_ms=ms["run_tlad_kernels_views"],
               tl_parity_rel_err=verdicts["tl_parity_rel_err"],
               ad_identity_rel_err=verdicts["ad_identity_rel_err"],
               tl_f32_vs_f64=dist),
        record("fwd", "cloudsc2_fwd_ckpt", "cloudsc2jax_torch/csrc/cloudsc2_nl.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:405", "drop-in cloudsc2_kernel_ad",
               ran_in_phase_9["fwd"]),
        record("din", "cloudsc2_tl_din", "cloudsc2jax_torch/csrc/cloudsc2_tl_din.cu",
               "cloudsc2jax/pallas/tlad_kernel.py:170", "drop-in cloudsc2_kernel_tl",
               ran_in_phase_9["din"],
               tl_parity_rel_err_by_lregcl=ran["tl_parity"]),
    ]


def compare_experiments(state, params):
    """Phase 12: the encoded TL and AD kernels and the fused TL+AD kernel
    against their plain versions on the card.  Returns the worst errors and
    the plain versions' times."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import DSCALE, run_tlad
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        launch_cloudsc2_ad,
        launch_cloudsc2_tl,
    )

    plain_ms = {}
    # -- 12. the three kernels against their plain versions on the card
    worst = {"tl_enc": {}, "ad_enc": {}, "fused": {}}
    counters = (ex.cloudsc2_tl_encoded, ex.cloudsc2_ad_encoded,
                ex.cloudsc2_tlad_fused)
    before = [f.launches for f in counters]
    expected = [0, 0, 0]
    cases = [(100, "float32", False, True), (100, "float32", True, True),
             (5000, "float32", False, True), (5001, "float32", True, True),
             (100, "float64", True, True), (5001, "float64", False, True)]
    # the fused kernel's other four variants (lregcl off), one tile each
    cases += [(100, name, ldrain1d, False) for name in ("float32", "float64")
              for ldrain1d in (False, True)]
    cases += [(ncol, name, False, True) for ncol, name in AB_SHAPES]
    for ncol, name, ldrain1d, lregcl in cases:
        print(f"[12] ncol={ncol} {name} ldrain1d={ldrain1d} lregcl={lregcl}:")
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        tol_tl, tol_ad = TLAD_TOLERANCE["tl"][name], TLAD_TOLERANCE["ad"][name]
        n_terms = inputs.pt.numel()
        id_tol = (1e-10 if name == "float64" else
                  cli.scaled_identity_tol(cli.PALLAS_AD_IDENTITY_TOL, n_terms))
        kw = dict(ldrain1d=ldrain1d)
        fkw = dict(kw, lregcl=lregcl)
        out, dout, adj = ex.cloudsc2_tlad_fused(inputs, params, **fkw)
        (r_out, r_dout, r_adj), t_fused = _timed(
            lambda: ex.cloudsc2_tlad_fused_reference(inputs, params, **fkw))
        u_out, u_dout, u_adj = run_tlad(inputs, params, **fkw)
        expected[2] += 1
        w = worst["fused"]
        _check("fused primal", out, r_out, tol_tl, w, name)
        _check("fused tangents", dout, r_dout, tol_tl, w, name)
        _check("fused adjoints", adj, r_adj, tol_ad, w, name)
        # the same two loops in one kernel: the two-kernel unit's results,
        # bit for bit where nvcc contracts both builds alike (it does in f32
        # with ldrain1d off), else up to FMA contraction
        _check("fused vs two-kernel TL", (*out, *dout), (*u_out, *u_dout),
               tol_tl, {}, name)
        _check("fused vs two-kernel AD", adj, u_adj, tol_ad, {}, name)
        same = all(torch.equal(a, b) for a, b in zip(
            (*out, *dout, *adj), (*u_out, *u_dout, *u_adj)))
        print(f"    fused vs two-kernel unit bit for bit: {same}")
        if name == "float32" and not ldrain1d and not same:
            raise AssertionError("the fused kernel differs from the two-kernel "
                                 "unit with ldrain1d off")
        rel, finite = cli.adjoint_identity(inputs, dout, adj, params, DSCALE)
        print(f"    fused adjoint identity rel err {rel:.3e} (tol {id_tol:g})")
        if not (finite and rel < id_tol):
            raise AssertionError("the fused unit fails the adjoint identity")
        w["identity_" + name] = max(w.get("identity_" + name, 0.0), rel)
        del out, dout, adj, r_out, r_dout, r_adj, u_out, u_dout, u_adj
        if name != "float32" or not lregcl:
            continue
        for keep in ENC_TLAD_KEEPS:
            print(f"    encoded TL and AD, keep_f32={keep}:")
            enc = ex.encode_blocked_inputs(inputs, params, fuse_satur=False,
                                           keep_f32=keep)
            out, dout, ckpts = ex.cloudsc2_tl_encoded(enc, params, dscale=DSCALE,
                                                      **kw)
            none, dout_n, ckpts_n = ex.cloudsc2_tl_encoded(
                enc, params, dscale=DSCALE, write_primal=False, **kw)
            (r_out, r_dout, r_ckpts), t_tl = _timed(
                lambda: ex.cloudsc2_tl_encoded_reference(enc, params,
                                                         dscale=DSCALE, **kw))
            adj = ex.cloudsc2_ad_encoded(enc, r_dout, r_ckpts, params, **kw)
            r_adj, t_ad = _timed(lambda: ex.cloudsc2_ad_encoded_reference(
                enc, r_dout, r_ckpts, params, **kw))
            if ncol == PLAIN_NCOL and keep == ENC_TLAD_KEEPS[0]:
                plain_ms.update(fused=t_fused, tl_enc=t_tl, ad_enc=t_ad)
            expected[0] += 2
            expected[1] += 1
            if none is not None:
                raise AssertionError("write_primal=False returned primal streams")
            w = worst["tl_enc"]
            _check("encoded TL primal", out, r_out, tol_tl, w, name)
            _check("encoded TL tangents", dout, r_dout, tol_tl, w, name)
            _check("encoded TL checkpoints", ckpts, r_ckpts, tol_tl, w, name)
            _check("encoded TL tangents, no primal", dout_n, r_dout, tol_tl, w, name)
            _check("encoded TL checkpoints, no primal", ckpts_n, r_ckpts, tol_tl,
                   w, name)
            _check("encoded AD adjoints", adj, r_adj, tol_ad, worst["ad_enc"], name)
            # the exact kernels on the decoded trajectory, under the same
            # flags: the same results bit for bit
            decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, params)
            x_out, x_dout, x_ckpts = launch_cloudsc2_tl(decoded, pre, params,
                                                        dscale=DSCALE, **kw)
            _, x_dout_n, x_ckpts_n = launch_cloudsc2_tl(
                decoded, pre, params, dscale=DSCALE, write_primal=False, **kw)
            x_adj = launch_cloudsc2_ad(decoded, pre, r_dout, r_ckpts, params, **kw)
            same = all(torch.equal(a, b) for a, b in zip(
                (*out, *dout, *ckpts, *dout_n, *ckpts_n, *adj),
                (*x_out, *x_dout, *x_ckpts, *x_dout_n, *x_ckpts_n, *x_adj)))
            print(f"    encoded TL and AD vs the exact kernels on the decoded "
                  f"inputs bit for bit: {same}")
            if not same:
                raise AssertionError("the encoded kernels differ from the exact "
                                     "kernels on the decoded inputs")
            # the pair as the harness chains it: the AD kernel on the TL
            # kernel's own tangents and checkpoints, dx = DSCALE x the decoded
            # inputs
            pair = ex.cloudsc2_ad_encoded(enc, dout, ckpts, params, **kw)
            expected[1] += 1
            rel, finite = cli.adjoint_identity(decoded, dout, pair, params, DSCALE)
            print(f"    encoded pair adjoint identity rel err {rel:.3e} "
                  f"(tol {id_tol:g})")
            if not (finite and rel < id_tol):
                raise AssertionError("the encoded pair fails the adjoint identity")
            worst["ad_enc"]["identity"] = max(worst["ad_enc"].get("identity", 0.0),
                                              rel)
            torch.cuda.synchronize()
            del enc, out, dout, ckpts, dout_n, ckpts_n, r_out, r_dout, r_ckpts
            del adj, r_adj, pair, decoded, x_out, x_dout, x_ckpts, x_dout_n
            del x_ckpts_n, x_adj
    if [f.launches - b for f, b in zip(counters, before)] != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs

    return {"worst": worst, "plain_ms": plain_ms}


def cli_experiments():
    """Phase 13: the ``kernel_ab`` harness as its users run it.  Returns the
    launches it made of the five kernels and its summary."""
    import os

    from cloudsc2jax_torch import kernel_ab
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    # -- 13. the harness as its users run it
    path = {"tl": cloudsc2_tl, "ad": cloudsc2_ad, "tl_enc": ex.cloudsc2_tl_encoded,
            "ad_enc": ex.cloudsc2_ad_encoded, "fused": ex.cloudsc2_tlad_fused}
    os.environ["CLOUDSC2_AB_NGPTOT"] = str(TIMING_NCOL)
    for f in path.values():
        f.launches = 0
    t0 = time.perf_counter()
    summary = kernel_ab.main(AB_CONFIGS)
    launches = {k: f.launches for k, f in path.items()}
    print(f"[13] kernel_ab {' '.join(AB_CONFIGS)} ({time.perf_counter() - t0:.1f} s); "
          f"kernel launches: {launches}")
    # per config a warm-up over the first (up to 4) variants, then the reps
    per_config = min(4, summary["reps"]) + summary["reps"]
    runs = {"tl": ("two", "noprim"), "ad": ("two", "noprim"), "fused": ("fused",),
            "tl_enc": ("enc", "encnp"), "ad_enc": ("enc", "encnp")}
    expected = {k: per_config * sum(AB_CONFIGS.count(c) for c in cfgs)
                for k, cfgs in runs.items()}
    if launches != expected:
        raise AssertionError(f"the harness did not run every unit through its "
                             f"kernels: expected {expected}")
    if summary["platform"] != "gpu" or len(summary["configs"]) != len(AB_CONFIGS):
        raise AssertionError(f"the harness's summary is incomplete: {summary}")
    return {"launches": launches, "summary": summary}


def time_experiments(state, params, compared, ran, fused_roles):
    """Phase 14: timing at the headline size, f32, distinct inputs per call.
    Returns the three kernels' JSON records."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import kernel_prelude
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, plain = compared["worst"], compared["plain_ms"]
    launches, summary = ran["launches"], ran["summary"]
    # -- 14. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [kernel_prelude(s, params) for s in sets]
    encs = [ex.encode_blocked_inputs(s, params, fuse_satur=False) for s in sets]
    tls = [ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE) for e in encs]
    ms = {
        "fused": _time_ms(lambda i, p: ex.launch_cloudsc2_tlad_fused(i, p, params),
                          list(zip(sets, pres)), 12),
        "tl_enc": _time_ms(
            lambda e: ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE),
            [(e,) for e in encs], 20),
        "tl_enc_noprim": _time_ms(
            lambda e: ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE,
                                                    write_primal=False),
            [(e,) for e in encs], 20),
        "ad_enc": _time_ms(
            lambda e, t: ex.launch_cloudsc2_ad_encoded(e, t[1], t[2], params),
            list(zip(encs, tls)), 20),
        "encode": _time_ms(
            lambda i: ex.encode_blocked_inputs(i, params, fuse_satur=False),
            [(s,) for s in sets], 3),
    }
    fused0 = ex.launch_cloudsc2_tlad_fused(sets[0], pres[0], params)
    plan = ex.fused_launch_plan(sets[0], params)
    nlev = base.pt.shape[0]
    enc_in = _nbytes(encs[0].streams, encs[0].enc, pres[0])
    bounds = {
        "fused": _bound("cloudsc2_tlad_fused", ncol, nlev,
                        _nbytes(sets[0], pres[0], fused0)),
        "tl_enc": _bound("cloudsc2_tl_enc", ncol, nlev, enc_in + _nbytes(tls[0])),
        "ad_enc": _bound("cloudsc2_ad_enc", ncol, nlev,
                         enc_in + _nbytes(tls[0][1], tls[0][2]) + _nbytes(sets[0])),
    }
    # what each kernel moves, where that differs from its bound's bytes: the
    # fused kernel reads the 16 inputs in both phases and its 8 tangent
    # streams back, and writes and reads its 3 checkpoints per level through
    # the ring; the TL without primal streams writes 8 streams fewer
    moved = {
        "fused": (bounds["fused"]["bytes"] + _nbytes(sets[0], pres[0], fused0[1])
                  + 2 * 3 * _nbytes(base.pt)),
        "tl_enc": bounds["tl_enc"]["bytes"],
        "tl_enc_noprim": bounds["tl_enc"]["bytes"] - _nbytes(tls[0][0]),
        "ad_enc": bounds["ad_enc"]["bytes"],
    }
    for label, t in ms.items():
        line = f"[14] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in moved:
            line += (f", {moved[label] / 1e9:.4f} GB moved, "
                     f"{moved[label] / (t * 1e-3) / 1e9:.1f} GB/s")
        if label in bounds:
            b = bounds[label]
            line += f", bound {b['bound_ms']:.4f} ms by {b['bound_by']}"
        print(line + f" at {ncol} columns f32")
    print(f"[14] fused kernel: {plan['tl_groups']}+{plan['ad_groups']} warpgroups "
          f"per block, {plan['blocks_per_sm']} blocks per SM, launched at "
          f"{plan['launch_registers']} registers (ptxas {plan['kernel_registers']}), "
          f"TL role {plan['tl_registers']}, AD role {plan['ad_registers']}, ring "
          f"depth {plan['depth']}, {plan['blocks']} blocks, {plan['shared_bytes']} B "
          f"shared per block, checkpoint ring {plan['scratch_bytes'] / 1e6:.1f} MB")
    for label, t in plain.items():
        print(f"[14] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32, in "
              f"the comparison of phase 12")
    print(f"[14] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    def record(kind, name, replaces, **extra):
        w = worst[kind]
        return {
            **bounds[kind],
            "name": name,
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": w["abs"],
            "max_rel_err_f32": w["float32"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "bytes_moved": moved[kind],
            "gb_per_s": moved[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **extra,
        }

    return [
        record("fused", "cloudsc2_tlad_fused",
               "cloudsc2jax/pallas/experiments.py:286",
               max_rel_err_f64=worst["fused"]["float64"],
               identity_f32=worst["fused"]["identity_float32"],
               identity_f64=worst["fused"]["identity_float64"],
               plan=plan, roles=fused_roles, kernel_ab=summary),
        record("tl_enc", "cloudsc2_tl_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:170",
               ms_noprim=ms["tl_enc_noprim"], encode_ms=ms["encode"],
               **_ptxas_of("cloudsc2_tl_enc", "cloudsc2_tl_enc_kernel",
                           "Lb0ELb1ELb1E", "ILj16381E")),
        record("ad_enc", "cloudsc2_ad_enc",
               "cloudsc2jax/pallas/tlad_kernel.py:454",
               identity_f32=worst["ad_enc"]["identity"],
               **_ptxas_of("cloudsc2_ad_enc", "cloudsc2_ad_enc_kernel",
                           "Lb0ELb1E", "ILj16381E")),
    ]


def check_exact_sass(specs) -> None:
    """Phase 2: the exact kernels' SASS against EXACT_SASS, where the build
    ran under the release it was recorded with."""
    import re

    from cloudsc2jax_torch.kernels import build

    m = re.search(r"release ([\d.]+), V([\d.]+)", build.nvcc_version())
    release = m.group(0) if m else "unknown"
    if release != EXACT_SASS_RELEASE:
        print(f"[2] exact kernels' SASS not checked: nvcc {release}, digests "
              f"recorded under {EXACT_SASS_RELEASE}")
        return
    changed = {}
    for lib, defines, flags in specs:
        # a library by its name, a build of it by the defines and flags it names
        key = " ".join((lib, *defines, *flags))
        if key not in EXACT_SASS and defines:
            continue
        digest = build.library_digest(build.sass_digests(build.sass(lib, defines, flags)))
        if key not in EXACT_SASS:
            print(f"[2] {key}'s SASS (not held): {digest}")
        elif digest != EXACT_SASS[key]:
            changed[key] = digest
    print(f"[2] exact kernels' SASS: {len(EXACT_SASS) - len(changed)} of "
          f"{len(EXACT_SASS)} libraries as recorded (nvcc {release})")
    if changed:
        raise AssertionError(f"the exact kernels' code changed: {changed}")


def _ptxas_of(lib: str, *marks: str) -> dict:
    """Registers and spill-store bytes of the first kernel entry of ``lib``
    whose mangled name holds every one of ``marks``."""
    from cloudsc2jax_torch.kernels import build

    for e in build.ptxas_report(lib):
        if all(m in e["entry"] for m in marks):
            return {"registers": e.get("registers"),
                    "spill_store_bytes": e.get("spill_store_bytes")}
    raise AssertionError(f"no kernel entry of {lib} matches {marks}")


def _l1_distance(got, ref) -> float:
    """Worst field of sum|got - ref| / sum|ref| (validate_mod.F90:271-284)."""
    return max(((a.double() - b.double()).abs().sum()
                / b.double().abs().sum().clamp_min(1e-30)).item()
               for a, b in zip(got, ref))


def _encode_nl(inputs, params, fuse_satur, keep, payload):
    """The encoding of ``inputs`` for one combination of phases 15 and 17."""
    import torch

    from cloudsc2jax_torch.kernels import experiments as ex

    keeps = {"default": ("pq", "plu", "paph"), "pq": ("pq",),
             "all": ex.ENCODED_STREAMS, "none": ()}
    return ex.encode_blocked_inputs(
        inputs, params, keep_f32=keeps[keep], fuse_satur=fuse_satur,
        payload_dtype=getattr(torch, payload))


def compare_nl_experiments(state, params):
    """Phase 15: the encoded and the resident NL kernels against their plain
    versions on the card.  Returns the worst errors and the plain versions'
    times."""
    import torch

    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex

    plain_ms = {}
    # -- 15. the two NL kernels against their plain versions on the card
    worst = {"enc": {}, "res": {}}
    counters = (ex.cloudsc2_nl_encoded, ex.cloudsc2_nl_resident)
    before = [f.launches for f in counters]
    expected = [0, 0]
    every = [(fs, keep, payload) for fs in (True, False) for keep in ENC_KEEPS
             for payload in ("int16", "bfloat16")]
    enc_cases = [(100, False, every), (100, True, ENC_SUBSET),
                 (5000, False, ENC_SUBSET), (5001, True, ENC_SUBSET),
                 (163840, False, ENC_SUBSET)]
    for ncol, ldrain1d, combos in enc_cases:
        print(f"[15] encoded NL ncol={ncol} ldrain1d={ldrain1d}:")
        inputs = state.device_kernel_inputs(ncol, dtype=torch.float32,
                                            device="cuda", pqs=True)
        exact = {True: km.cloudsc2_nl(inputs, params, ldrain1d=ldrain1d),
                 False: km.cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)[0]}
        for fuse_satur, keep, payload in combos:
            enc = _encode_nl(inputs, params, fuse_satur, keep, payload)
            got = ex.cloudsc2_nl_encoded(enc, params, ldrain1d=ldrain1d)
            ref, t_enc = _timed(lambda: ex.cloudsc2_nl_encoded_reference(
                enc, params, ldrain1d=ldrain1d))
            if ncol == PLAIN_NCOL and (fuse_satur, keep, payload) == ENC_SUBSET[0]:
                plain_ms["enc"] = t_enc
            expected[0] += 1
            what = (f"fuse_satur={fuse_satur} keep={keep} {payload} "
                    f"({ex.nl_encoded_kernel(enc)} mask)")
            _check(what, got, ref, ENC_NL_TOLERANCE, worst["enc"], "float32")
            # the same level body on the same decoded values: the exact
            # kernel's results, bit for bit
            decoded, pre = ex.decode_inputs(enc), ex._prelude(enc, params)
            twin = (km.launch_cloudsc2_nl(decoded, pre, params, ldrain1d=ldrain1d)
                    if fuse_satur else km.launch_cloudsc2_fwd_ckpt(
                        decoded, pre, params, ldrain1d=ldrain1d)[0])
            same = all(torch.equal(a, b) for a, b in zip(got, twin))
            print(f"      bit for bit the exact kernel's outputs on the decoded "
                  f"inputs: {same}")
            if not same:
                _check(what + " against the exact kernel on the decoded inputs",
                       got, twin, TOLERANCE["float32"], {}, "float32")
                raise AssertionError(f"{what}: not bit for bit the exact "
                                     f"kernel's outputs on the decoded inputs")
            del decoded, twin
            l1 = _l1_distance(got, exact[fuse_satur])
            print(f"      encoded against exact kernel: sum|a-b|/sum|b| {l1:.3e}")
            if keep == "all":
                # nothing is quantised: the exact kernel's results, up to the
                # FMA contraction of two builds
                _check(what + " against the exact kernel", got, exact[fuse_satur],
                       TOLERANCE["float32"], {}, "float32")
            elif payload == "int16" and not l1 < ENC_L1_BUDGET:
                raise AssertionError(f"{what}: int16 storage moved an output by "
                                     f"{l1:.3e} in L1, budget {ENC_L1_BUDGET:g}")
            key = "l1_" + payload
            if keep != "all":
                worst["enc"][key] = max(worst["enc"].get(key, 0.0), l1)
        torch.cuda.synchronize()
    res_cases = [(100, name, ld) for name in ("float32", "float64")
                 for ld in (False, True)]
    res_cases += [(5000, "float32", False), (5001, "float64", True)]
    res_cases += COMPARE_SHAPES
    for ncol, name, ldrain1d in res_cases:
        print(f"[15] resident NL ncol={ncol} {name} ldrain1d={ldrain1d}:")
        dtype = getattr(torch, name)
        inputs = state.device_kernel_inputs(ncol, dtype=dtype, device="cuda",
                                            pqs=True)
        nlev = inputs.pt.shape[0]
        ref, t_res = _timed(lambda: ex.cloudsc2_nl_resident_reference(
            inputs, params, ldrain1d=ldrain1d))
        if (ncol, name) == (PLAIN_NCOL, "float32"):
            plain_ms["res"] = t_res
        fwd, _ = km.cloudsc2_fwd_ckpt(inputs, params, ldrain1d=ldrain1d)
        rings = [("default ring", None, None), ("128 x 8", 128, 8), ("64 x 3", 64, 3)]
        if ncol <= 5001:
            per_col = ex.resident_ring(nlev, dtype, tile=1, depth=nlev)[2]
            rings.append(("every level resident", RESIDENT_LIMIT_BYTES // per_col,
                          nlev))
        for label, tile, depth in rings:
            got = ex.cloudsc2_nl_resident(inputs, params, ldrain1d=ldrain1d,
                                          tile=tile, depth=depth)
            expected[1] += 1
            ring = ex.resident_ring(nlev, dtype, tile, depth)
            _check(f"{label} {ring}", got, ref, TOLERANCE[name], worst["res"], name)
            same = all(torch.equal(a, b) for a, b in zip(got, fwd))
            print(f"      bit for bit the forward-checkpoint kernel's outputs: {same}")
            if not same:
                # one level body in two kernels: at most FMA contraction apart
                _check(f"{label} against the forward-checkpoint kernel", got, fwd,
                       TOLERANCE[name], {}, name)
        torch.cuda.synchronize()
    try:
        ex.cloudsc2_nl_resident(inputs, params, tile=128, depth=nlev)
    except ValueError as err:
        print(f"[15] a ring that does not fit is refused before the launch: {err}")
    else:
        raise AssertionError("a 128-column ring of every level was not refused")
    if [f.launches - b for f, b in zip(counters, before)] != expected:
        raise AssertionError("the comparison did not launch the kernels")
    del inputs, exact, enc, got, ref, fwd

    return {"worst": worst, "plain_ms": plain_ms}


def cli_nl_experiments(state, params):
    """Phase 16: ``bw_probe`` and ``encoding_study`` through their entry
    points and the two NL sweeps through their wrappers.  Returns the
    kernels' launches, the probe's records keyed by (mix, weighted), the
    plain stream's record and the study's i16 error."""
    import os

    import torch

    from cloudsc2jax_torch import bw_probe, encoding_study
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex

    # -- 16. the entry points and wrappers as their users run them
    path = {"probe": bw_probe.window_stream, "enc": ex.cloudsc2_nl_encoded,
            "res": ex.cloudsc2_nl_resident}
    for f in path.values():
        f.launches = 0
    env = {k: os.environ.get(k) for k in os.environ if k.startswith("CLOUDSC2_BW_PROBE_")}
    for k in env:
        del os.environ[k]
    probes = {}
    t0 = time.perf_counter()
    try:
        os.environ["CLOUDSC2_BW_PROBE_MB"] = "256"
        stream = bw_probe.main([])
        os.environ["CLOUDSC2_BW_PROBE_NB"] = str(TIMING_NCOL // (64 * 128))
        runs = 0
        for mix, reads, writes, rev, weighted in bw_probe.KERNEL_MIXES:
            for compute in ((0, 0), weighted):
                if compute is None:
                    continue
                os.environ["CLOUDSC2_BW_PROBE_WINDOWS"] = f"{reads}x{writes}"
                os.environ["CLOUDSC2_BW_PROBE_REV"] = "1" if rev else "0"
                os.environ["CLOUDSC2_BW_PROBE_COMPUTE"] = "%d,%d" % compute
                rec = bw_probe.main([])
                if (rec["platform"], rec["columns"], rec["rev"]) != (
                        "gpu", TIMING_NCOL, rev):
                    raise AssertionError(f"the probe ran another mix: {rec}")
                probes[mix, compute != (0, 0)] = rec
                runs += 1
                torch.cuda.empty_cache()
    finally:
        for k in [k for k in os.environ if k.startswith("CLOUDSC2_BW_PROBE_")]:
            del os.environ[k]
        os.environ.update({k: v for k, v in env.items() if v is not None})
    print(f"[16] bw_probe: plain stream and {runs} window runs "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    table = encoding_study.main([])
    i16 = table["encodings"]["i16"]["max_field_relerr"]
    print(f"[16] encoding_study on the card ({time.perf_counter() - t0:.1f} s): "
          f"i16 max field error {i16:.3e}")
    budget = table["budgets"]["onchip_budget_1e4_eps32"]
    if not 1e-4 < i16 < 2e-4 or any(
            table["encodings"][s]["max_field_relerr"] <= budget
            for s in ("bf16", "f16")):
        raise AssertionError(f"the encoding study left its band: {table}")
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    exact = km.cloudsc2_nl(base, params)
    fwd, _ = km.cloudsc2_fwd_ckpt(base, params)
    got = ex.cloudsc2_nl_encoded(ex.encode_blocked_inputs(base, params), params)
    l1 = _l1_distance(got, exact)
    res = ex.cloudsc2_nl_resident(base, params)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in (*got, *res))
    res_rel, _ = _max_rel_err(res, fwd)
    print(f"[16] wrappers at {ncol} f32 columns: encoded against exact "
          f"sum|a-b|/sum|b| {l1:.3e}; resident against the forward-checkpoint "
          f"kernel max rel err {res_rel:.3e}; finite={finite}")
    if not (finite and l1 < ENC_L1_BUDGET and res_rel <= TOLERANCE["float32"]):
        raise AssertionError("the NL experiments' wrappers failed their checks")
    launches = {k: f.launches for k, f in path.items()}
    print(f"[16] kernel launches: {launches}")
    # per window run: the self-check forward and reversed, the warm-up, the reps
    per_run = 2 + bw_probe.WARMUP + 20
    if launches != {"probe": runs * per_run, "enc": 1, "res": 1}:
        raise AssertionError("the entry points did not run through their kernels")
    return {"launches": launches, "probes": probes, "stream": stream, "i16": i16}


def time_nl_experiments(state, params, compared, ran):
    """Phase 17: timing of the NL variants at the headline size, f32,
    distinct inputs per call, and the probe's mix as one library call.
    Returns the three kernels' JSON records."""
    import torch

    from cloudsc2jax_torch import bw_probe, roofline
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    worst, launches = compared["worst"], ran["launches"]
    probes, stream, i16 = ran["probes"], ran["stream"], ran["i16"]
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda",
                                      pqs=True)
    # -- 17. timing at the headline size, f32, distinct inputs per call
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [km.kernel_prelude(s, params) for s in sets]
    nlev = base.pt.shape[0]
    pairs = list(zip(sets, pres))
    enc_variants = {"enc": (True, "default", "int16"), "enc_pq": (True, "pq", "int16"),
                    "enc_bf16": (True, "default", "bfloat16"),
                    "enc_all_f32": (True, "all", "int16")}
    every_tile, every_depth, _ = ex.resident_ring(
        nlev, torch.float32,
        tile=RESIDENT_LIMIT_BYTES // ex.resident_ring(nlev, torch.float32, 1, nlev)[2],
        depth=nlev)
    res_variants = {"res": (None, None, 30), "res_128x8": (128, 8, 30),
                    "res_all": (every_tile, every_depth, 3)}
    out_bytes = 8 * _nbytes(base.pt)
    ms, moved, regs, kernels = {}, {}, {}, {}

    def time_exact(label):
        ms[label] = _time_ms(lambda i, q: km.launch_cloudsc2_nl(i, q, params),
                             pairs, 30)
        moved[label] = _nbytes(sets[0]._replace(pqs=None), pres[0]) + out_bytes
        regs[label] = _ptxas_of("cloudsc2_nl", "cloudsc2_nl_kernelIfLb0E")

    time_exact("exact")
    for label, (fuse_satur, keep, payload) in enc_variants.items():
        encs = [_encode_nl(s, params, fuse_satur, keep, payload) for s in sets]
        ms[label] = _time_ms(lambda e: ex.launch_cloudsc2_nl_encoded(e, params),
                             [(e,) for e in encs], 30)
        moved[label] = _nbytes(encs[0].streams, encs[0].levels, pres[0]) + out_bytes
        # the kernel that ran: the fixed mask's (its mask in the name) or the
        # runtime mask's (0)
        kernels[label] = ex.nl_encoded_kernel(encs[0])
        mask = ex.encoded_mask(encs[0]) if kernels[label] == "fixed" else 0
        regs[label] = _ptxas_of(
            "cloudsc2_nl_enc",
            f"ILb0ELb0ELb{int(payload == 'bfloat16')}ELj{mask}E")
        del encs
    for label, (tile, depth, calls) in res_variants.items():
        ms[label] = _time_ms(
            lambda i, q: ex.launch_cloudsc2_nl_resident(i, q, params, tile=tile,
                                                        depth=depth),
            pairs, calls)
        moved[label] = _nbytes(sets[0], pres[0]) + out_bytes
        regs[label] = _ptxas_of("cloudsc2_nl_res", "IfLb0E")
    time_exact("exact#2")
    ms["encode"] = _time_ms(lambda i: ex.encode_blocked_inputs(i, params),
                            [(s,) for s in sets], 3)
    for label, t in ms.items():
        line = f"[17] {label}: {t:.4f} ms/call, {ncol / (t * 1e-3):.4e} cols/s"
        if label in moved:
            b = roofline.bound_of(moved[label],
                                  roofline.operations("cloudsc2_nl", ncol, nlev))
            line += (f", {moved[label] / 1e9:.4f} GB, "
                     f"{moved[label] / (t * 1e-3) / 1e9:.1f} GB/s, bound "
                     f"{b['bound_ms']:.4f} ms by {b['bound_by']}, "
                     f"{regs[label]['registers']} registers, "
                     f"{regs[label]['spill_store_bytes']} B spill stores")
        if label in kernels:
            line += f", {kernels[label]}-mask kernel"
        print(line + f" at {ncol} columns f32")
    print(f"[17] resident rings: default {ex.resident_ring(nlev, torch.float32)}, "
          f"every level resident {(every_tile, every_depth)}")
    del sets, pres, pairs, base
    # the plain versions were timed in the comparison of phase 15; the probe's
    # is one elementwise pass per output
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = [torch.rand((nlev, PLAIN_NCOL), generator=gen, device="cuda")
            for _ in range(15)]
    plain = {**compared["plain_ms"], "probe": _time_once_ms(
        lambda a: bw_probe.window_stream_reference(a, 2.0, 8), arrs)}
    for label, t in plain.items():
        print(f"[17] plain_{label}: {t:.4f} ms/call at {PLAIN_NCOL} columns f32")
    # One PyTorch call computes the probe's outputs when no chain is mixed in:
    # out[j] = in[(j+1) % R] + s * in[j % R] for all W outputs at once.  Timed
    # here on the probe's own arrays beside the kernel, used nowhere in the port.
    reads, writes = 15, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = [torch.rand((nlev, ncol), generator=gen, device="cuda")
            for _ in range(reads)]
    out = [torch.empty_like(arrs[0]) for _ in range(writes)]
    lhs = [arrs[(j + 1) % reads] for j in range(writes)]
    rhs = [arrs[j % reads] for j in range(writes)]
    want = bw_probe.window_stream_reference(arrs, 2.0, writes)
    for label, got in (
            ("kernel", bw_probe.launch_window_stream(arrs, 2.0, writes, out=out)),
            ("library call", torch._foreach_add(lhs, rhs, alpha=2.0))):
        if not all(torch.allclose(a, b, rtol=1e-6, atol=0.0)
                   for a, b in zip(got, want)):
            raise AssertionError(f"the probe's {label} disagrees with its plain "
                                 f"version at {reads}x{writes}")
    del want, got
    scales = [(1e-6 * (i + 1),) for i in range(20)]
    library = {
        "probe_kernel": _time_ms(
            lambda s: bw_probe.launch_window_stream(arrs, s, writes, out=out),
            scales, 20),
        "foreach_add": _time_ms(
            lambda s: torch._foreach_add(lhs, rhs, alpha=s), scales, 20),
        "probe_kernel#2": _time_ms(
            lambda s: bw_probe.launch_window_stream(arrs, s, writes, out=out),
            scales, 20),
    }
    for label, t in library.items():
        print(f"[17] {reads}x{writes} {label}: {t:.4f} ms/call, "
              f"{(reads + writes) * _nbytes(arrs[0]) / (t * 1e-3) / 1e9:.1f} GB/s "
              f"of the kernel's traffic at {ncol} columns f32")
    del arrs, out, lhs, rhs
    print(f"[17] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    def record(kind, name, replaces, **extra):
        return {
            **_bound(f"cloudsc2_nl_{kind}", ncol, nlev, moved[kind]),
            "name": name,
            "route": "cuda",
            "source": f"cloudsc2jax_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": worst[kind]["abs"],
            "max_rel_err_f32": worst[kind]["float32"],
            "ms": ms[kind],
            "plain_ms": plain[kind],
            "plain_ncol": PLAIN_NCOL,
            "gb_per_s": moved[kind] / (ms[kind] * 1e-3) / 1e9,
            "ncol": ncol,
            **regs[kind],
            **extra,
        }

    nl_mix = probes["nl", False]
    # the probe's own operations: one multiply-add and one add per output
    probe_record = {
        **_bound("bw_probe", ncol, nlev, nl_mix["traffic_bytes"]),
        "name": "bw_probe",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/bw_probe.cu",
        "replaces": "tools/bw_probe.py:78",
        "launches": launches["probe"],
        "max_abs_err": max(r["self_check_max_abs_err"] for r in probes.values()),
        "ms": nl_mix["ms_per_call"],
        "plain_ms": plain["probe"],
        "plain_ncol": PLAIN_NCOL,
        "gb_per_s": nl_mix["attained_gbps"],
        "ncol": ncol,
        "library_ms": library["foreach_add"],
        "library_call": "torch._foreach_add(in[(j+1)%R], in[j%R], alpha=s)",
        "ms_beside_library": (library["probe_kernel"], library["probe_kernel#2"]),
        "stream_gb_per_s": stream["attained_gbps"],
        "mixes": {f"{mix}{'_weighted' if w else ''}": {
            k: r[k] for k in ("windows", "rev", "compute_per_element",
                              "traffic_bytes", "ms_per_call", "attained_gbps")}
            for (mix, w), r in probes.items()},
    }
    records = [
        record("enc", "cloudsc2_nl_enc", "cloudsc2jax/pallas/cloudsc2_kernel.py:348",
               ms_exact=ms["exact"], ms_exact_again=ms["exact#2"],
               ms_keep_pq=ms["enc_pq"], ms_bf16=ms["enc_bf16"],
               ms_all_f32=ms["enc_all_f32"], encode_ms=ms["encode"],
               kernels={"ms": kernels["enc"], "ms_keep_pq": kernels["enc_pq"],
                        "ms_bf16": kernels["enc_bf16"],
                        "ms_all_f32": kernels["enc_all_f32"]},
               l1_vs_exact_int16=worst["enc"]["l1_int16"],
               l1_vs_exact_bf16=worst["enc"]["l1_bfloat16"],
               encoding_study_i16=i16),
        record("res", "cloudsc2_nl_res", "cloudsc2jax/pallas/cloudsc2_kernel.py:424",
               max_rel_err_f64=worst["res"]["float64"],
               ring=ex.resident_ring(nlev, torch.float32)[:2],
               ms_128x8=ms["res_128x8"], ms_every_level_resident=ms["res_all"],
               ring_every_level_resident=(every_tile, every_depth)),
        probe_record,
    ]
    return records


def _plain_chunked(state, params, variant: str, ngptot: int, chunk: int) -> float:
    """``run_chunked``'s checksum through the plain versions on the card:
    the same chunks, generated at the same offsets, through the plain NL
    sweep or the plain TL then AD sweeps, summed in the same order."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE, checksum
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_nl_reference
    from cloudsc2jax_torch.kernels.tlad_kernel import (
        cloudsc2_ad_reference,
        cloudsc2_tl_reference,
    )

    acc = torch.zeros((), dtype=torch.float32, device="cuda")
    for i in range(ngptot // chunk):
        inputs = state.device_kernel_inputs(chunk, dtype=torch.float32,
                                            device="cuda", pqs=variant == "tlad",
                                            col_offset=i * chunk)
        if variant == "nl":
            res = cloudsc2_nl_reference(inputs, params)
        else:
            out, dout, ckpts = cloudsc2_tl_reference(inputs, params, dscale=DSCALE)
            res = (out, dout, cloudsc2_ad_reference(inputs, dout, ckpts, params))
        acc = acc + checksum(res)
    return float(acc)


def _bench_worker() -> int:
    """``python -m cloudsc2jax_torch.bench`` with the environment's knobs, in
    this process, under the launch counters of the NL, resident NL, TL and AD
    kernels zeroed just before; prints the bench's record, then one
    ``LAUNCHES <json>`` line."""
    from cloudsc2jax_torch import bench
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_nl
    from cloudsc2jax_torch.kernels.experiments import cloudsc2_nl_resident
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    kernels = {"nl": cloudsc2_nl, "res": cloudsc2_nl_resident, "tl": cloudsc2_tl,
               "ad": cloudsc2_ad}
    for f in kernels.values():
        f.launches = 0
    bench.main([])
    print("LAUNCHES " + json.dumps({k: f.launches for k, f in kernels.items()}),
          flush=True)
    return 0


def _bench(env: dict, phase: str) -> tuple:
    """One bench record in a process of its own (``--bench-worker``):
    ``(record, launches)``; raises if it failed or names no card."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--bench-worker"],
                          env={**os.environ, **env}, capture_output=True, text=True,
                          cwd=ROOT, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr)
        raise AssertionError(f"bench {env} failed (exit code {proc.returncode})")
    (line, launches) = proc.stdout.strip().splitlines()[-2:]
    record = json.loads(line)
    launches = json.loads(launches.removeprefix("LAUNCHES "))
    print(f"[{phase}] bench {env} ({time.perf_counter() - t0:.1f} s): {line}")
    print(f"[{phase}] its kernel launches: {launches}")
    if not (record["platform"] == "gpu" and record["device_name"]
            and record["power_limit_w"] > 0):
        raise AssertionError(f"bench {env}: the record names no card")
    return record, launches


def compare_truth(state, params):
    """Phase 20 (a)-(c) in a process of its own: the truth path's TL+AD unit
    with and without the level checkpoint and in NPROMA blocks, each run's
    wall seconds and peak of allocated memory, the three held to each other;
    the CLI's truth route; the bench's truth records."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import run_tlad

    card = _nvidia_smi("name,power.limit")
    # the process's first units, at one block of nproma 128: what each of the
    # 128 blocks of the CLI's `tlad 1 16384 128` would cost the host
    warm = state.device_inputs(128, dtype=torch.float64, device="cuda")
    for remat in (False, True):
        t0 = time.perf_counter()
        run_tlad(warm, params, backend="truth", remat=remat)
        torch.cuda.synchronize()
        print(f"[20] truth run_tlad at 128 f64 columns, remat={remat}: "
              f"{time.perf_counter() - t0:.2f} s ({card})")
    del warm
    inputs = state.device_inputs(TRUTH_NCOL, dtype=torch.float64, device="cuda")
    runs, ref = {}, None
    for label, kw in (("remat=False", dict(remat=False)),
                      ("remat=True", dict(remat=True)),
                      (f"remat=True, nproma={TRUTH_NPROMA}",
                       dict(remat=True, nproma=TRUTH_NPROMA))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = run_tlad(inputs, params, backend="truth", **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(x).all()) for t in out for x in t)
        # the results on the host, so that every run's peak holds the
        # inputs alone
        out = [[x.cpu() for x in t] for t in out]
        if ref is None:
            ref, rel = out, 0.0
        else:
            rel = max(_max_rel_err(a, b)[0] for a, b in zip(out, ref))
        runs[label] = {"s": seconds, "peak_bytes": peak, "held_bytes": held,
                       "rel_err_vs_remat_false": rel}
        print(f"[20] truth run_tlad at {TRUTH_NCOL} f64 columns, {label}: "
              f"{seconds:.2f} s, peak allocated {peak / 1e9:.4f} GB "
              f"({(peak - held) / 1e9:.4f} GB above the {held / 1e9:.4f} GB held "
              f"before), max rel err against remat=False {rel:.3e} (tol "
              f"{TRUTH_TOLERANCE:g}), finite={finite} ({card})")
        if not finite or not rel <= TRUTH_TOLERANCE:
            raise AssertionError(f"truth run_tlad {label} disagrees or is not finite")
        del out
    if not (runs["remat=True"]["peak_bytes"] < runs["remat=False"]["peak_bytes"]):
        raise AssertionError("the level checkpoint did not lower the peak memory")

    t0 = time.perf_counter()
    rc = cli.main(TRUTH_CLI_RUN + ["--device", "cuda"])
    cli_s = time.perf_counter() - t0
    print(f"[20] cli {' '.join(TRUTH_CLI_RUN)} (truth route, "
          f"{TRUTH_NCOL // TRUTH_NPROMA} blocks): rc={rc} ({cli_s:.1f} s, {card})")
    if rc != 0:
        raise AssertionError("the CLI's truth route failed its identity")

    bench = {}
    for variant in ("nl", "tlad"):
        record, launches = _bench({**TRUTH_BENCH, "CLOUDSC2_BENCH_VARIANT": variant},
                                  "20")
        if any(launches.values()):
            raise AssertionError(f"the bench's truth {variant} launched a kernel")
        bench[variant] = record
    return {"runs": runs, "cli_s": cli_s, "bench": bench, "card": card}


def phase_20(records: list, probes: dict, nlev: int) -> dict:
    """Phase 20 in the main process: the bench's kernel modes, the roofline
    of every kernel, the native shim and the evidence battery."""
    import torch

    from cloudsc2jax_torch import roofline
    from cloudsc2jax_torch.native import hostinfo, library_path

    card = _nvidia_smi("name,power.limit")
    # (c) the bench's kernel modes, each in a process of its own
    modes = {}
    for env in BENCH_MODES:
        record, launches = _bench(env, "20")
        key = "resident" if "CLOUDSC2_BENCH_MODE" in env else "standard"
        counter = "res" if key == "resident" else "nl"
        if launches[counter] == 0:
            raise AssertionError(f"the bench's {key} mode did not launch its kernel")
        modes[key] = {"record": record, "launches": launches[counter]}

    # (d) every kernel's bound from roofline.py; its bytes were held to the
    # run's own tensors where the record was made
    for rec in records:
        mix = KERNEL_MIX[rec["name"]]
        r = roofline.report(rec["name"], rec["ncol"], nlev, ms=rec["ms"],
                            ceiling_gbps=probes[mix, False]["attained_gbps"])
        print(f"[20] roofline {rec['name']}: {r['bytes']} B (= the run's tensors), "
              f"{r['operations']} operations, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}; {r['ms']:.4f} ms, {r['attained_gbps']:.1f} GB/s, "
              f"{r['share_of_bound']:.1%} of the bound, "
              f"{r['share_of_ceiling']:.1%} of the probe at its mix ({card})")

    # (e) the native shim, built with g++ on first use
    cpu = hostinfo.sched_getcpu()
    print(f"[20] native shim {library_path()}: built={hostinfo.available}, "
          f"sched_getcpu()={cpu}, energy_uj()={hostinfo.energy_uj()}")
    if not hostinfo.available or cpu < 0:
        raise AssertionError("the native shim was not built or has no core id")

    # (f) the evidence battery's list and one cheap step
    torch.cuda.empty_cache()
    evidence = [sys.executable, "-m", "cloudsc2jax_torch.onchip_evidence"]
    listed = subprocess.run(evidence + ["--list"], capture_output=True, text=True,
                            cwd=ROOT, timeout=120)
    out = WORK_DIR / "onchip_evidence.json"
    out.unlink(missing_ok=True)
    step = subprocess.run(evidence + ["--steps", "probe_stream", "--out", str(out)],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    steps = len(listed.stdout.strip().splitlines())
    print(f"[20] onchip_evidence --list: rc={listed.returncode}, {steps} steps; "
          f"--steps probe_stream: rc={step.returncode}, {step.stdout.strip()}")
    done = json.loads(out.read_text())["results"]["probe_stream"] if out.is_file() else {}
    if listed.returncode != 0 or step.returncode != 0 or not done.get("ok"):
        print(listed.stderr + step.stderr)
        raise AssertionError("the evidence battery did not list or run its step")
    return modes


def compare_chunked(state, params):
    """Phase 18, its comparison: ``run_chunked`` through the kernels against
    the same chunks through the plain versions on the card.  Returns each
    variant's error relative to the checksum."""
    from cloudsc2jax_torch.drivers import run_chunked

    ngptot, chunk = CHUNK_COMPARE
    rel = {}
    for variant in ("nl", "tlad"):
        n, got = run_chunked(state, ngptot, variant=variant, chunk=chunk,
                             sublanes=1)
        t0 = time.perf_counter()
        ref = _plain_chunked(state, params, variant, ngptot, chunk)
        rel[variant] = abs(got - ref) / abs(ref)
        tol = CHUNK_TOLERANCE[variant]
        print(f"[18] run_chunked {variant}, {n} columns in chunks of {chunk}: "
              f"checksum {got!r} against the plain versions' {ref!r} "
              f"({time.perf_counter() - t0:.1f} s): rel err {rel[variant]:.3e} "
              f"(tol {tol:g})")
        if n != ngptot or not rel[variant] <= tol:
            raise AssertionError(f"run_chunked {variant} disagrees with the "
                                 f"plain versions")
    return {"rel": rel}


def chunked_and_bench(state, params) -> dict:
    """Phase 18 in the main process: the chunked main path under its launch
    counters, ``fused_gen``, the chunk loop under the sync debug mode, the
    bench's four variants and the profiled, golden-writing CLI run.
    Returns the launches of the main path and the bench's records."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.drivers import (
        _CHUNK_CACHE,
        chunk_columns,
        chunk_loop,
        run_chunked,
    )
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_nl
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl

    # -- 18. the chunked main path, counters zeroed just before
    cloudsc2_nl.launches = cloudsc2_tl.launches = cloudsc2_ad.launches = 0
    sums = {}
    for variant in ("nl", "tlad"):
        for chunk in CHUNK_SIZES:
            t0 = time.perf_counter()
            n, sums[variant, chunk] = run_chunked(state, CHUNK_NGPTOT,
                                                  variant=variant, chunk=chunk)
            print(f"[18] run_chunked {variant}, {n} columns in chunks of {chunk}: "
                  f"checksum {sums[variant, chunk]!r} "
                  f"({time.perf_counter() - t0:.2f} s, first call included)")
            if n != CHUNK_NGPTOT:
                raise AssertionError(f"run_chunked ran {n} columns")
        a, b = (sums[variant, c] for c in CHUNK_SIZES)
        rel = abs(a - b) / abs(b)
        tol = CHUNK_INVARIANCE_RTOL[variant]
        print(f"[18] {variant}: the two decompositions differ by {rel:.3e} "
              f"(tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"run_chunked {variant} depends on the chunk size")
    launches = {"nl": cloudsc2_nl.launches, "tl": cloudsc2_tl.launches,
                "ad": cloudsc2_ad.launches}
    chunks = sum(CHUNK_NGPTOT // c for c in CHUNK_SIZES)
    print(f"[18] kernel launches on the chunked main path: {launches}")
    if launches != {"nl": chunks, "tl": chunks, "ad": chunks}:
        raise AssertionError("the chunked main path did not run through the "
                             f"kernels once per chunk ({chunks} chunks)")

    # -- 18. fused_gen against regeneration, two chunks of a whole period
    for variant in ("nl", "tlad"):
        period = chunk_columns(state, CHUNK_SIZES[1], variant=variant,
                               fused_gen=True)
        fused = run_chunked(state, 2 * period, variant=variant,
                            chunk=CHUNK_SIZES[1], fused_gen=True)
        regen = run_chunked(state, 2 * period, variant=variant, chunk=period)
        print(f"[18] {variant} fused_gen {fused!r}, regenerated {regen!r}")
        if fused != regen:
            raise AssertionError(f"{variant}: fused_gen is not bit-identical "
                                 "to regeneration")
    _CHUNK_CACHE.clear()

    # -- 18. the chunk loop under the sync debug mode: the stored columns are
    # on the card since the first run above, so nothing may synchronise
    for variant in ("nl", "tlad"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            n, acc = chunk_loop(state, CHUNK_NGPTOT, variant=variant,
                                chunk=CHUNK_SIZES[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        value = float(acc)
        print(f"[18] {variant}: {CHUNK_NGPTOT // CHUNK_SIZES[1]} chunks under "
              f"set_sync_debug_mode('error'), then one read: {value!r}")
        if value != sums[variant, CHUNK_SIZES[1]]:
            raise AssertionError(f"{variant}: the loop under the sync debug mode "
                                 "gave another checksum")

    # -- 18. the bench, each variant in a process of its own, with the
    # card's memory given back first
    _CHUNK_CACHE.clear()
    torch.cuda.empty_cache()
    bench = {}
    for variant in BENCH_VARIANTS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cloudsc2jax_torch.bench"],
            env={**os.environ, "CLOUDSC2_BENCH_VARIANT": variant},
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            raise AssertionError(f"bench {variant} failed (exit code "
                                 f"{proc.returncode})")
        (line,) = proc.stdout.strip().splitlines()
        print(f"[18] bench {variant} ({time.perf_counter() - t0:.1f} s): {line}")
        rec = bench[variant] = json.loads(line)
        if not (rec["platform"] == "gpu" and rec["device_name"]
                and rec["power_limit_w"] > 0):
            raise AssertionError(f"bench {variant}: the record names no card")
        if variant.startswith("chunked") and not (
                rec["streamed_gb"] > rec["device_memory_gb"] > rec["peak_allocated_gb"]):
            raise AssertionError(f"bench {variant} did not stream past the "
                                 "card's memory within it")

    # -- 18. the CLI, profiled, writing a golden file in a temporary
    # directory; the file then validates a second run
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    profile = WORK_DIR / "profile"
    shutil.rmtree(profile, ignore_errors=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        os.environ["CLOUDSC2_WRITE_REFERENCE"] = "1"
        try:
            rc = cli.main(PROFILE_RUN + ["--device", "cuda", "--profile", str(profile)])
        finally:
            del os.environ["CLOUDSC2_WRITE_REFERENCE"]
            os.chdir(cwd)
        (trace,) = profile.glob("*.pt.trace.json")
        named = "cloudsc2_nl_kernel" in trace.read_text()
        print(f"[18] cli {' '.join(PROFILE_RUN)} --profile: rc={rc}, trace "
              f"{trace.name} ({trace.stat().st_size} B) names cloudsc2_nl_kernel: "
              f"{named}")
        if rc != 0 or not named:
            raise AssertionError("the profiled CLI run failed or its trace "
                                 "misses the kernel")
        written = pathlib.Path(tmp) / cli.WRITTEN_REFERENCE
        rc = cli.main(PROFILE_RUN + ["--device", "cuda", "--reference", str(written)])
        print(f"[18] cli {' '.join(PROFILE_RUN)} --reference {written.name}: rc={rc}")
        if rc != 0:
            raise AssertionError("the written golden file does not validate")
    return {"launches": launches, "bench": bench,
            "sums": {v: sums[v, CHUNK_SIZES[1]] for v in ("nl", "tlad")}}


def _rank_worker() -> int:
    """One rank of phase 19, its rank and group from the environment: the
    CLI's runs and ``run_chunked(mesh=)``, each under launch counters zeroed
    just before and read just after; prints one ``RANK <json>`` line."""
    import torch

    from cloudsc2jax_torch import cli, dist
    from cloudsc2jax_torch.drivers import chunk_loop
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import cloudsc2_nl
    from cloudsc2jax_torch.kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl
    from cloudsc2jax_torch.state import Cloudsc2State

    kernels = {"nl": cloudsc2_nl, "tl": cloudsc2_tl, "ad": cloudsc2_ad}

    def zero():
        for f in kernels.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in kernels.items()}

    if not dist.initialize():
        raise RuntimeError("a rank worker needs CLOUDSC2_NUM_PROCESSES > 1")
    try:
        result = {"rank": dist.rank(), "runs": [], "chunked": {}}
        for argv in MP_RUNS:
            zero()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--device", "cuda"])
            result["runs"].append({"argv": argv, "rc": rc, "launches": read(),
                                   "s": time.perf_counter() - t0})
        state = Cloudsc2State.load(FIXTURES / "input.npz")
        mesh = dist.column_mesh("cuda")
        for variant in ("nl", "tlad"):
            kw = dict(variant=variant, chunk=CHUNK_SIZES[1], mesh=mesh)
            chunk_loop(state, CHUNK_SIZES[1], **kw)  # the stored columns up
            zero()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                n, accs = chunk_loop(state, CHUNK_NGPTOT, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            result["chunked"][variant] = {
                "columns": n, "checksum": float(mesh.reduce(accs, "sum")),
                "launches": read()}
        print("RANK " + json.dumps(result), flush=True)
    finally:
        dist.finalize()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multi_process(chunk_sums: dict) -> dict:
    """Phase 19: two ranks on the card against one process.  Returns each
    rank's launches and checksums, the per-rank ms and the combined
    columns/s."""
    import re

    import torch

    from cloudsc2jax_torch import cli, dist

    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(MP_RANKS):
            env = {**os.environ, "CLOUDSC2_NUM_PROCESSES": str(MP_RANKS),
                   "CLOUDSC2_PROCESS_ID": str(rank),
                   "CLOUDSC2_COORDINATOR": f"localhost:{port}"}
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker"],
                env=env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=MP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [x for x in out.splitlines() if x.startswith("RANK ")]
        if p.returncode != 0 or len(lines) != 1:
            print(out + err)
            raise AssertionError(f"rank {rank} failed (exit code {p.returncode})")
        ranks.append(json.loads(lines[0][5:]))
    # rank 0's gathered tables, one per CLI run: each rank's TOTAL row and
    # the combined row
    tables = re.findall(r"^\s+rank(\d)\s+(?:\S+\s+){4}(\S+)\s+\S+\s+(\S+)\s+"
                        r"TOTAL @ rank#\d$|^\s+\d+proc\s+(?:\S+\s+){4}(\S+)\s+"
                        r"\S+\s+(\S+)\s+TOTAL$", outs[0][1], re.M)
    for line in outs[0][1].splitlines():
        if any(m in line for m in ("NUMPROC", "rank:lane", "TOTAL", "tlad outputs")):
            print(f"[19] rank 0: {line.strip()}")
    timing = []
    for argv, start in zip(MP_RUNS, range(0, 3 * len(MP_RUNS), 3)):
        rows = tables[start:start + 3]
        timing.append({
            "run": " ".join(argv),
            "rank_ms": [float(r[1]) for r in rows[:MP_RANKS]],
            "combined_cols_per_s": float(rows[MP_RANKS][4]),
            "combined_ms": float(rows[MP_RANKS][3])})
    print(f"[19] {MP_RANKS} ranks ({wall:.1f} s): " + json.dumps(timing))
    for r in ranks:
        for run in r["runs"]:
            print(f"[19] rank {r['rank']} cli {' '.join(run['argv'])}: rc={run['rc']} "
                  f"({run['s']:.1f} s), launches {run['launches']}")
            need = ("nl",) if run["argv"][0] == "nl" else ("tl", "ad")
            if run["rc"] != 0 or min(run["launches"][k] for k in need) < 1:
                raise AssertionError(f"rank {r['rank']}: {run['argv']} failed or "
                                     "did not run through its kernels")
        for variant, c in r["chunked"].items():
            ref = chunk_sums[variant]
            rel = abs(c["checksum"] - ref) / abs(ref)
            tol = CHUNK_INVARIANCE_RTOL[variant]
            chunks = CHUNK_NGPTOT // CHUNK_SIZES[1]
            print(f"[19] rank {r['rank']} run_chunked(mesh=) {variant}: "
                  f"{c['columns']} columns, checksum {c['checksum']!r} against one "
                  f"process's {ref!r}: rel {rel:.3e} (tol {tol:g}), chunk loop "
                  f"under set_sync_debug_mode('error'), launches {c['launches']}")
            need = ("nl",) if variant == "nl" else ("tl", "ad")
            if (c["columns"] != CHUNK_NGPTOT or not rel <= tol
                    or any(c["launches"][k] != chunks for k in need)):
                raise AssertionError(f"rank {r['rank']}: run_chunked(mesh=) "
                                     f"{variant} disagrees with one process")
    if ranks[0]["chunked"] != ranks[1]["chunked"]:
        raise AssertionError("the ranks' run_chunked totals differ")
    # the same runs as one process: the same verdicts
    for argv in MP_RUNS:
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[19] one process: cli {' '.join(argv)}: rc={rc}")
        if rc != 0:
            raise AssertionError(f"one process failed where two ranks passed: {argv}")
    worst = dist.dryrun(1)
    print(f"[19] dist.dryrun(1) on {torch.cuda.get_device_name(0)}: {worst}")
    print(f"[19] {_nvidia_smi('name,power.limit')}: two processes time-slice "
          "one card, so the combined rate is no scaling")
    return {"ranks": ranks, "timing": timing, "dryrun": worst}


def _nl_compare_and_cli(state, params):
    """Phases 3 and 4: the NL kernel against its plain version, then the NL
    main path through the CLI.  Returns (worst absolute error, worst relative
    error by dtype, the main path's launches)."""
    import torch

    from cloudsc2jax_torch import cli
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        cloudsc2_nl,
        cloudsc2_nl_reference,
        kernel_prelude,
    )

    # -- 3. kernel against the plain version on the card
    launches0 = cloudsc2_nl.launches
    worst_abs = 0.0
    worst_rel = {"float32": 0.0, "float64": 0.0}
    cases = [(ncol, name, ldrain1d)
             for ncol in (100, 5000)
             for name in ("float32", "float64")
             for ldrain1d in (False, True)]
    cases += COMPARE_SHAPES
    for ncol, name, ldrain1d in cases:
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda")
        _check_prelude(inputs, params, f"[3] ncol={ncol} {name}")
        got = cloudsc2_nl(inputs, params, ldrain1d=ldrain1d)
        ref = cloudsc2_nl_reference(inputs, params, ldrain1d=ldrain1d)
        torch.cuda.synchronize()
        rel, absolute = _max_rel_err(got, ref)
        tol = TOLERANCE[name]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        print(f"[3] ncol={ncol} {name} ldrain1d={ldrain1d}:"
              f" max rel err {rel:.3e} (tol {tol:g}), max abs err"
              f" {absolute:.3e}, finite={finite}")
        if not finite or not rel <= tol:
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"(ncol={ncol}, {name}, ldrain1d={ldrain1d})")
        worst_rel[name] = max(worst_rel[name], rel)
        worst_abs = max(worst_abs, absolute)
    if cloudsc2_nl.launches - launches0 != len(cases):
        raise AssertionError("the comparison did not launch the kernel")
    _nl_f64_counters(state, params)

    # -- 4. main path through the CLI entry point
    cloudsc2_nl.launches = kernel_prelude.launches = 0
    for argv in MAIN_PATH_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[4] cli {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"main path failed validation: {argv}")
    main_launches = cloudsc2_nl.launches
    prelude_launches = kernel_prelude.launches
    print(f"[4] kernel launches on the main path: {main_launches}, the "
          f"prelude's kernel: {prelude_launches}")
    if main_launches < len(MAIN_PATH_RUNS):
        raise AssertionError("the main path did not run through the kernel")
    if prelude_launches < main_launches:
        raise AssertionError("the main path did not run its prelude through the "
                             "prelude's kernel")
    for argv in TRUTH_RUNS:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--device", "cuda"])
        print(f"[4] cli {' '.join(argv)} (truth path): rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"the truth path failed validation: {argv}")
    return worst_abs, worst_rel, main_launches, prelude_launches


def _nl_f64_counters(state, params) -> None:
    """Phase 3's line on the f64 NL sweep the main path launches (ldrain1d
    off): the counters its ``nl_sweep`` span carries, read by the one reader
    of the sweeps' counters, beside ptxas' spills of the same entry."""
    import torch

    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import _evap, _load_kernel

    like = state.device_kernel_inputs(128, dtype=torch.float64, device="cuda").pt
    evap = int(_evap(params, False))
    got = build.occupancy(_load_kernel(), "cloudsc2_nl", like, evap)
    mark = f"cloudsc2_nl_kernelIdLb{evap}E"
    (ptxas,) = [e for e in build.ptxas_report("cloudsc2_nl") if mark in e["entry"]]
    print(f"[3] f64 NL sweep (evap {evap}): {got['registers']} registers, "
          f"{got['local_bytes']} B local, {ptxas['spill_store_bytes']} / "
          f"{ptxas['spill_load_bytes']} B spill stores / loads (ptxas), "
          f"{got['blocks_per_sm']} blocks ({4 * got['blocks_per_sm']} warps) per SM")


def _check_prelude(inputs, params, what: str) -> None:
    """The tropopause eta of ``kernel_prelude`` (one launch of the prelude's
    kernel) against the plain expression on the same card tensors, bit for
    bit."""
    import torch

    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        kernel_prelude,
        level_scalars,
        tropopause_eta_lm,
    )

    launches = kernel_prelude.launches
    got = kernel_prelude(inputs, params).ztrpaus
    want = tropopause_eta_lm(inputs.pt + params.ptsphy * inputs.ten_t,
                             level_scalars(params, inputs.pt)[0])
    torch.cuda.synchronize()
    if kernel_prelude.launches != launches + 1:
        raise AssertionError(f"{what}: the prelude did not launch its kernel")
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the prelude's kernel gives another "
                             f"tropopause eta than the plain expression")


# ------------------------------------------------------------------ phase 21
def _flat(*trees):
    """The tensors of nested tuples, in order (None skipped)."""
    out = []
    for t in trees:
        if t is None:
            continue
        if hasattr(t, "numel"):
            out.append(t)
        else:
            out += _flat(*t)
    return out


def _same(got, want) -> bool:
    """Equal bit for bit, tensor by tensor (a zero's sign aside)."""
    import torch

    got, want = _flat(got), _flat(want)
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _held(what: str, got, one, tol: float, distances: dict, key: str) -> None:
    """A schedule's results against the one-level kernel's: bit for bit, or
    else the worst field and its distance printed and held at ``tol``."""
    if _same(got, one):
        return
    got, one = _flat(got), _flat(one)
    rels = [_max_rel_err([a], [b])[0] for a, b in zip(got, one)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    print(f"    {what}: NOT bit for bit; worst output #{worst} at max rel err "
          f"{rels[worst]:.3e} (tol {tol:g})")
    distances[key] = max(distances.get(key, 0.0), rels[worst])
    if not rels[worst] <= tol:
        raise AssertionError(f"{what} differs from the one-level kernel")


def _kernel_runs(state, params, ncol: int) -> dict:
    """Every kernel library of the port, its wrapper's launch at ``ncol`` f32
    columns: name -> a function that launches it once and returns its
    outputs (the determinism check of phase 21 launches each twice)."""
    import torch

    from cloudsc2jax_torch import bw_probe
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import schedules as sch
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    x = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda", pqs=True)
    pre = km.kernel_prelude(x, params)
    dx = Cloudsc2Inputs(*(DSCALE * v for v in x))
    _, dout, ck = tk.launch_cloudsc2_tl(x, pre, params, dscale=DSCALE)
    enc = ex.encode_blocked_inputs(x, params, fuse_satur=False)
    b16 = ex.encode_blocked_inputs(x, params, fuse_satur=False,
                                   payload_dtype=torch.bfloat16)
    nl_enc = ex.encode_blocked_inputs(x, params)
    arrs = [x.pt + j for j in range(15)]
    runs = {
        "cloudsc2_nl": lambda: km.launch_cloudsc2_nl(x, pre, params),
        "cloudsc2_fwd_ckpt": lambda: km.launch_cloudsc2_fwd_ckpt(x, pre, params),
        "cloudsc2_nl_res": lambda: ex.launch_cloudsc2_nl_resident(x, pre, params),
        "cloudsc2_nl_enc": lambda: ex.launch_cloudsc2_nl_encoded(nl_enc, params),
        "cloudsc2_tl": lambda: tk.launch_cloudsc2_tl(x, pre, params, dscale=DSCALE),
        "cloudsc2_tl_din": lambda: tk.launch_cloudsc2_tl_din(x, dx, pre, params),
        "cloudsc2_ad": lambda: tk.launch_cloudsc2_ad(x, pre, dout, ck, params),
        "cloudsc2_tlad_fused": lambda: ex.launch_cloudsc2_tlad_fused(x, pre, params),
        "cloudsc2_tl_enc": lambda: ex.launch_cloudsc2_tl_encoded(enc, params, dscale=DSCALE),
        "cloudsc2_ad_enc": lambda: ex.launch_cloudsc2_ad_encoded(enc, dout, ck, params),
        "bw_probe": lambda: bw_probe.launch_window_stream(arrs, 2.0, 8),
        "cloudsc2_ad_xscat": lambda: sch.launch_cloudsc2_ad_streams(x, pre, dout, ck,
                                                                    params),
        "cloudsc2_tl_enc_bf16": lambda: ex.launch_cloudsc2_tl_encoded(
            b16, params, dscale=DSCALE),
        "cloudsc2_ad_enc_bf16": lambda: ex.launch_cloudsc2_ad_encoded(b16, dout, ck,
                                                                      params),
    }
    for c in CHUNK_LEVELS_RUN:
        runs[f"cloudsc2_tl_chunk C={c}"] = (lambda c=c: sch.launch_cloudsc2_tl_chunked(
            x, pre, params, dscale=DSCALE, chunk_levels=c))
        runs[f"cloudsc2_tl_din_chunk C={c}"] = (
            lambda c=c: sch.launch_cloudsc2_tl_din_chunked(x, dx, pre, params,
                                                           chunk_levels=c))
        runs[f"cloudsc2_fwd_chunk C={c}"] = (
            lambda c=c: sch.launch_cloudsc2_fwd_ckpt_chunked(x, pre, params,
                                                             chunk_levels=c))
        runs[f"cloudsc2_ad_chunk C={c}"] = (lambda c=c: sch.launch_cloudsc2_ad_streams(
            x, pre, dout, ck, params, chunk_levels=c))
    return runs


def compare_schedules(state, params):
    """Phase 21, its comparison: the 17-stream AD kernel, the chunked
    sweeps and the bfloat16 encoded sweeps on the card, bit for bit against
    the kernels whose schedule they change and against their plain
    versions; then every kernel library launched twice.  Returns the worst
    errors, the distances of schedules that are not bit for bit, the plain
    versions' times and the determinism verdicts."""
    import torch

    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import schedules as sch
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    if CHUNK_LEVELS_RUN != sch.CHUNK_LEVELS:
        raise AssertionError(f"the chunked libraries are built for {sch.CHUNK_LEVELS}")
    worst = {k: {} for k in SCHEDULE_KINDS}
    distances, plain_ms, same_as_inplace = {}, {}, {}
    # -- 21. the new kernels against the kernels they reschedule and their
    # plain versions on the card
    for ncol, name, ldrain1d, lregcl, fold, plain in SCHEDULE_CASES:
        print(f"[21] ncol={ncol} {name} ldrain1d={ldrain1d} lregcl={lregcl} "
              f"fold_seeds={fold}{' with the plain versions' if plain else ''}:")
        inputs = state.device_kernel_inputs(ncol, dtype=getattr(torch, name),
                                            device="cuda", pqs=True)
        pre = km.kernel_prelude(inputs, params)
        dx = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
        tol = {"tl_chunk": TLAD_TOLERANCE["tl"][name],
               "din_chunk": TLAD_TOLERANCE["tl"][name],
               "fwd_chunk": TOLERANCE[name], "ad_chunk": TLAD_TOLERANCE["ad"][name],
               "xscat": TLAD_TOLERANCE["ad"][name]}
        kw = dict(ldrain1d=ldrain1d, lregcl=lregcl)
        akw = dict(kw, fold_seeds=fold)
        one = {"tl_chunk": tk.launch_cloudsc2_tl(inputs, pre, params, dscale=DSCALE,
                                                  **kw),
               "din_chunk": tk.launch_cloudsc2_tl_din(inputs, dx, pre, params, **kw),
               "fwd_chunk": km.launch_cloudsc2_fwd_ckpt(inputs, pre, params,
                                                        ldrain1d=ldrain1d)}
        _, seeds, ckpts = one["tl_chunk"]
        inplace = tk.launch_cloudsc2_ad(inputs, pre, seeds, ckpts, params, **akw)
        one["ad_chunk"] = raw = sch.launch_cloudsc2_ad_streams(
            inputs, pre, seeds, ckpts, params, **akw)
        same = _same(sch._assembled(raw), inplace)
        same_as_inplace[f"{ncol} {name}"] = same
        print(f"    17-stream AD assembled vs the in-place AD bit for bit: {same}")
        if not same:
            raise AssertionError("the 17-stream AD's assembled adjoints differ "
                                 "from the in-place kernel's")
        ref = {}
        if plain:
            (ref["tl_chunk"], t_tl) = _timed(lambda: tk.cloudsc2_tl_reference(
                inputs, params, dscale=DSCALE, pre=pre, **kw))
            ref["din_chunk"], t_din = _timed(lambda: tk.cloudsc2_tl_reference(
                inputs, params, d_inputs=dx, pre=pre, **kw)[:2])
            ref["fwd_chunk"], t_fwd = _timed(lambda: km.cloudsc2_fwd_ckpt_reference(
                inputs, params, ldrain1d=ldrain1d, pre=pre))
            ref["ad_chunk"], t_ad = _timed(lambda: sch.cloudsc2_ad_streams_reference(
                inputs, seeds, ckpts, params, pre=pre, **akw))
            if name == "float32":
                plain_ms.update(tl_chunk=t_tl, din_chunk=t_din, fwd_chunk=t_fwd,
                                ad_chunk=t_ad, xscat=t_ad)
            _check("17-stream AD raw streams", raw, ref["ad_chunk"], tol["xscat"],
                   worst["xscat"], name)
        for c in CHUNK_LEVELS_RUN:
            got = {"tl_chunk": sch.launch_cloudsc2_tl_chunked(
                       inputs, pre, params, dscale=DSCALE, chunk_levels=c, **kw),
                   "din_chunk": sch.launch_cloudsc2_tl_din_chunked(
                       inputs, dx, pre, params, chunk_levels=c, **kw),
                   "fwd_chunk": sch.launch_cloudsc2_fwd_ckpt_chunked(
                       inputs, pre, params, ldrain1d=ldrain1d, chunk_levels=c),
                   "ad_chunk": sch.launch_cloudsc2_ad_streams(
                       inputs, pre, seeds, ckpts, params, chunk_levels=c, **akw)}
            print(f"    C={c}: " + ", ".join(
                f"{k} bit for bit {_same(v, one[k])}" for k, v in got.items()))
            for k, v in got.items():
                _held(f"{k} C={c}", v, one[k], tol[k], distances, f"{k} C={c}")
                if plain:
                    _check(f"{k} C={c} against its plain version", _flat(v),
                           _flat(ref[k]), tol[k], worst[k], name)
        del one, got, ref, raw, inplace
        if name != "float32":
            continue
        for keep in ENC_TLAD_KEEPS:
            enc = ex.encode_blocked_inputs(inputs, params, fuse_satur=False,
                                           keep_f32=keep, payload_dtype=torch.bfloat16)
            tl = ex.launch_cloudsc2_tl_encoded(enc, params, dscale=DSCALE, **kw)
            tln = ex.launch_cloudsc2_tl_encoded(enc, params, dscale=DSCALE,
                                                write_primal=False, **kw)
            adj = ex.launch_cloudsc2_ad_encoded(enc, tl[1], tl[2], params, **akw)
            decoded, epre = ex.decode_inputs(enc), ex._prelude(enc, params)
            x_tl = tk.launch_cloudsc2_tl(decoded, epre, params, dscale=DSCALE, **kw)
            x_tln = tk.launch_cloudsc2_tl(decoded, epre, params, dscale=DSCALE,
                                          write_primal=False, **kw)
            x_adj = tk.launch_cloudsc2_ad(decoded, epre, tl[1], tl[2], params, **akw)
            same = _same((tl, tln, adj), (x_tl, x_tln, x_adj))
            print(f"    bfloat16 keep_f32={keep} ({ex.encoded_mask(enc):#x}): TL and AD "
                  f"vs the exact kernels on the decoded inputs bit for bit: {same}")
            if not same:
                raise AssertionError("the bfloat16 kernels differ from the exact "
                                     "kernels on the decoded inputs")
            if plain:
                r_tl, t_tl = _timed(lambda: ex.cloudsc2_tl_encoded_reference(
                    enc, params, dscale=DSCALE, **kw))
                r_adj, t_ad = _timed(lambda: ex.cloudsc2_ad_encoded_reference(
                    enc, tl[1], tl[2], params, **akw))
                if keep == ENC_TLAD_KEEPS[0]:
                    plain_ms.update(tl_bf16=t_tl, ad_bf16=t_ad)
                _check("bfloat16 TL", _flat(tl), _flat(r_tl), BF16_TOLERANCE,
                       worst["tl_bf16"], name)
                _check("bfloat16 TL, no primal", _flat(tln), _flat(r_tl[1:]),
                       BF16_TOLERANCE, worst["tl_bf16"], name)
                _check("bfloat16 AD", adj, r_adj, TLAD_TOLERANCE["ad"][name],
                       worst["ad_bf16"], name)
            del enc, tl, tln, adj, decoded, x_tl, x_tln, x_adj
        torch.cuda.synchronize()
    # every kernel library twice on the same inputs: the same bits
    determinism = {}
    for label, run in _kernel_runs(state, params, SCHEDULE_PLAIN_NCOL).items():
        first, second = run(), run()
        torch.cuda.synchronize()
        determinism[label] = _same(first, second)
    print(f"[21] two launches bit for bit, {len(determinism)} kernels at "
          f"{SCHEDULE_PLAIN_NCOL} f32 columns: "
          f"{sum(determinism.values())} of {len(determinism)}")
    if not all(determinism.values()):
        raise AssertionError(f"a kernel is not deterministic: {determinism}")
    return {"worst": worst, "distances": distances, "plain_ms": plain_ms,
            "same_as_inplace": same_as_inplace, "determinism": determinism}


def schedules_main(state, params, compared) -> list:
    """Phase 21 in the main process: the schedules through the entry points
    a user calls, under their launch counters zeroed just before, then their
    times at the headline size.  Returns the seven kernels' JSON records."""
    import torch

    from cloudsc2jax_torch import cli, kernel_ab
    from cloudsc2jax_torch.drivers import DSCALE
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km
    from cloudsc2jax_torch.kernels import experiments as ex
    from cloudsc2jax_torch.kernels import schedules as sch
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    counters = {"xscat": (sch.cloudsc2_ad_xscat, "launches"),
                "ad_chunk": (sch.cloudsc2_ad_chunked, "launches"),
                "tl_chunk": (sch.cloudsc2_tl_chunked, "launches"),
                "din_chunk": (sch.cloudsc2_tl_din_chunked, "launches"),
                "fwd_chunk": (sch.cloudsc2_fwd_ckpt_chunked, "launches"),
                "tl_bf16": (ex.cloudsc2_tl_encoded, "launches_bf16"),
                "ad_bf16": (ex.cloudsc2_ad_encoded, "launches_bf16")}
    # -- 21. the main paths: kernel_ab's configs of the schedules at 327,680
    # f32 columns; the standard contract assembled from the chunked sweeps at
    # each C against its drop-ins; the encoded TL and AD on a bfloat16
    # encoding through their wrappers
    for f, attr in counters.values():
        setattr(f, attr, 0)
    os.environ["CLOUDSC2_AB_NGPTOT"] = str(TIMING_NCOL)
    t0 = time.perf_counter()
    summary = kernel_ab.main(SCHEDULE_AB)
    print(f"[21] kernel_ab {' '.join(SCHEDULE_AB)} ({time.perf_counter() - t0:.1f} s)")
    std = state.device_inputs(STD_CHUNK_NCOL, dtype=torch.float32, device="cuda")
    dstd = Cloudsc2Inputs(*(DSCALE * x for x in std))
    out1, dout1 = tk.cloudsc2_kernel_tl(std, dstd, params)
    adj1 = tk.cloudsc2_kernel_ad(std, dout1, params)
    lm, dlm = tk.to_levels_major(std), tk.to_levels_major(dstd)
    seeds = tk.seed_streams(dout1, params)
    for c in CHUNK_LEVELS_RUN:
        # the standard contract's halves with the chunked sweeps in place of
        # the one-level ones, assembled as the drop-ins assemble theirs
        streams = sch.cloudsc2_tl_din_chunked(lm, dlm, params, chunk_levels=c)
        outc, doutc = (km.unblock_outputs(x, params) for x in streams)
        fwd, ckpts = sch.cloudsc2_fwd_ckpt_chunked(lm, params, chunk_levels=c)
        adjc = sch.cloudsc2_ad_chunked(lm, seeds, ckpts, params, chunk_levels=c,
                                       fold_seeds=False)
        got = (outc, doutc, km.unblock_outputs(fwd, params),
               Cloudsc2Inputs(*(x.T for x in adjc)))
        same = _same(got, (out1, dout1, *adj1))
        print(f"[21] the standard contract at {STD_CHUNK_NCOL} f32 columns, C={c}: "
              f"bit for bit one level a step: {same}")
        _held(f"the standard contract at C={c}", got, (out1, dout1, *adj1),
              TLAD_TOLERANCE["ad"]["float32"], {}, "")
    del std, dstd, lm, dlm, seeds, out1, dout1, adj1, outc, doutc, adjc, fwd, got
    base = state.device_kernel_inputs(TIMING_NCOL, dtype=torch.float32, device="cuda",
                                      pqs=True)
    b16 = ex.encode_blocked_inputs(base, params, fuse_satur=False,
                                   payload_dtype=torch.bfloat16)
    _, dout, ckpts = ex.cloudsc2_tl_encoded(b16, params, dscale=DSCALE)
    adj = ex.cloudsc2_ad_encoded(b16, dout, ckpts, params)
    n_terms = base.pt.numel()
    rel, finite = cli.adjoint_identity(ex.decode_inputs(b16), dout, adj, params, DSCALE)
    id_tol = cli.scaled_identity_tol(cli.PALLAS_AD_IDENTITY_TOL, n_terms)
    print(f"[21] bfloat16 encoded TL+AD at {TIMING_NCOL} f32 columns: adjoint "
          f"identity rel err {rel:.3e} (tol {id_tol:g}), finite={finite}")
    if not (finite and rel < id_tol):
        raise AssertionError("the bfloat16 encoded pair fails the adjoint identity")
    del b16, dout, ckpts, adj
    launches = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
    per_config = min(4, summary["reps"]) + summary["reps"]
    chunks = sum(c.startswith("chunk:") for c in SCHEDULE_AB)
    expected = {"xscat": per_config * sum(c in ("xscat", "xscatnp") for c in SCHEDULE_AB),
                "ad_chunk": per_config * chunks + len(CHUNK_LEVELS_RUN),
                "tl_chunk": per_config * chunks, "din_chunk": len(CHUNK_LEVELS_RUN),
                "fwd_chunk": len(CHUNK_LEVELS_RUN), "tl_bf16": 1, "ad_bf16": 1}
    print(f"[21] kernel launches on the schedules' main paths: {launches}")
    if launches != expected:
        raise AssertionError(f"the schedules' main paths did not run through their "
                             f"kernels: expected {expected}")

    # -- 21. timing at the headline size, f32, distinct inputs per call
    ncol, nlev = TIMING_NCOL, base.pt.shape[0]
    sets = [base] + [Cloudsc2Inputs(*(x.roll(s, dims=1) for x in base))
                     for s in (37, 71)]
    pres = [km.kernel_prelude(s, params) for s in sets]
    dsets = [Cloudsc2Inputs(*(DSCALE * x for x in s)) for s in sets]
    tls = [tk.launch_cloudsc2_tl(i, p, params, dscale=DSCALE) for i, p in zip(sets, pres)]
    pairs = list(zip(sets, pres))
    ad_args = list(zip(sets, pres, tls))

    def tl(c):
        if c == 1:
            return _time_ms(lambda i, p: tk.launch_cloudsc2_tl(
                i, p, params, dscale=DSCALE), pairs, 20)
        return _time_ms(lambda i, p: sch.launch_cloudsc2_tl_chunked(
            i, p, params, dscale=DSCALE, chunk_levels=c), pairs, 20)

    def din(c):
        if c == 1:
            return _time_ms(lambda i, d, p: tk.launch_cloudsc2_tl_din(
                i, d, p, params), list(zip(sets, dsets, pres)), 20)
        return _time_ms(lambda i, d, p: sch.launch_cloudsc2_tl_din_chunked(
            i, d, p, params, chunk_levels=c), list(zip(sets, dsets, pres)), 20)

    def fwd(c):
        if c == 1:
            return _time_ms(lambda i, p: km.launch_cloudsc2_fwd_ckpt(i, p, params),
                            pairs, 20)
        return _time_ms(lambda i, p: sch.launch_cloudsc2_fwd_ckpt_chunked(
            i, p, params, chunk_levels=c), pairs, 20)

    def ad_streams(c):
        return _time_ms(lambda i, p, t: sch.launch_cloudsc2_ad_streams(
            i, p, t[1], t[2], params, chunk_levels=c), ad_args, 20)

    ms = {"ad": _time_ms(lambda i, p, t: tk.launch_cloudsc2_ad(i, p, t[1], t[2], params),
                         ad_args, 20),
          "xscat": ad_streams(1), "tl": tl(1), "din": din(1), "fwd": fwd(1)}
    raws = [sch.launch_cloudsc2_ad_streams(i, p, t[1], t[2], params)
            for i, p, t in ad_args]
    ms["assembly"] = _time_ms(lambda r: sch.assemble_shifted_adjoints(*r[-4:]),
                              [(r,) for r in raws], 20)
    by_chunk = {k: {} for k in ("tl_chunk", "din_chunk", "fwd_chunk", "ad_chunk")}
    for c in CHUNK_LEVELS_RUN:
        by_chunk["tl_chunk"][c], by_chunk["din_chunk"][c] = tl(c), din(c)
        by_chunk["fwd_chunk"][c], by_chunk["ad_chunk"][c] = fwd(c), ad_streams(c)
    encs = {p: [ex.encode_blocked_inputs(s, params, fuse_satur=False,
                                         payload_dtype=getattr(torch, p))
                for s in sets] for p in ("int16", "bfloat16")}
    etls = {p: [ex.launch_cloudsc2_tl_encoded(e, params, dscale=DSCALE) for e in es]
            for p, es in encs.items()}
    for p, key in (("int16", "enc"), ("bfloat16", "bf16")):
        ms[f"tl_{key}"] = _time_ms(lambda e: ex.launch_cloudsc2_tl_encoded(
            e, params, dscale=DSCALE), [(e,) for e in encs[p]], 20)
        ms[f"tl_{key}_noprim"] = _time_ms(lambda e: ex.launch_cloudsc2_tl_encoded(
            e, params, dscale=DSCALE, write_primal=False), [(e,) for e in encs[p]], 20)
        ms[f"ad_{key}"] = _time_ms(lambda e, t: ex.launch_cloudsc2_ad_encoded(
            e, t[1], t[2], params), list(zip(encs[p], etls[p])), 20)
    card = _nvidia_smi("name,power.limit")
    for label, t in {**ms, **{f"{k} C={c}": v for k, d in by_chunk.items()
                              for c, v in d.items()}}.items():
        print(f"[21] {label}: {t:.4f} ms/call at {ncol} columns f32 ({card})")
    print(f"[21] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # bytes held to this run's tensors
    enc_in = _nbytes(encs["bfloat16"][0].streams, encs["bfloat16"][0].enc, pres[0])
    ad_in = _nbytes(sets[0], pres[0], tls[0][1], tls[0][2])
    moved = {"xscat": ad_in + _nbytes(raws[0]),
             "ad_chunk": ad_in + _nbytes(raws[0]),
             "tl_chunk": _nbytes(sets[0], pres[0], tls[0]),
             "din_chunk": _nbytes(sets[0], pres[0], dsets[0]) + 16 * _nbytes(base.pt),
             "fwd_chunk": _nbytes(sets[0], pres[0]) + 11 * _nbytes(base.pt),
             "tl_bf16": enc_in + _nbytes(etls["bfloat16"][0]),
             "ad_bf16": enc_in + _nbytes(etls["bfloat16"][0][1:])
             + _nbytes(sets[0])}
    worst, plain = compared["worst"], compared["plain_ms"]
    distances = compared["distances"]
    common = {"route": "cuda", "ncol": ncol, "plain_ncol": SCHEDULE_PLAIN_NCOL,
              "card": card}

    def record(kind, name, replaces, time_ms, **extra):
        w = worst[kind]
        return {**_bound(name, ncol, nlev, moved[kind]), **common, "name": name,
                "source": f"cloudsc2jax_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": launches[kind],
                "max_abs_err": w.get("abs", 0.0),
                "max_rel_err_f32": w.get("float32"), "max_rel_err_f64": w.get("float64"),
                "ms": time_ms, "plain_ms": plain[kind],
                "gb_per_s": moved[kind] / (time_ms * 1e-3) / 1e9, **extra}

    def chunk_extra(kind, lib, marks, one_ms):
        regs = {c: _ptxas_of(lib, *marks(c)) for c in CHUNK_LEVELS_RUN}
        return {"ms_by_chunk": by_chunk[kind], "ms_one_level_same_run": one_ms,
                "registers_by_chunk": {c: r["registers"] for c, r in regs.items()},
                "spill_store_bytes_by_chunk": {c: r["spill_store_bytes"]
                                               for c, r in regs.items()},
                "not_bit_for_bit": {k: v for k, v in distances.items()
                                    if k.startswith(kind)}}

    first = CHUNK_LEVELS_RUN[0]
    return [
        record("xscat", "cloudsc2_ad_xscat", "cloudsc2jax/pallas/tlad_kernel.py:454",
               ms["xscat"], ms_inplace_same_run=ms["ad"], assembly_ms=ms["assembly"],
               assembled_bit_for_bit=compared["same_as_inplace"],
               **_ptxas_of("cloudsc2_ad_xscat", "cloudsc2_ad_shifted_kernel",
                           "IfLb0ELb1ELi1E")),
        record("ad_chunk", "cloudsc2_ad_chunk", "cloudsc2jax/pallas/tlad_kernel.py:454",
               by_chunk["ad_chunk"][first], **chunk_extra(
                   "ad_chunk", "cloudsc2_ad_chunk",
                   lambda c: ("cloudsc2_ad_shifted_kernel", f"IfLb0ELb1ELi{c}E"),
                   ms["xscat"])),
        record("tl_chunk", "cloudsc2_tl_chunk", "cloudsc2jax/pallas/tlad_kernel.py:170",
               by_chunk["tl_chunk"][first], **chunk_extra(
                   "tl_chunk", "cloudsc2_tl_chunk",
                   lambda c: ("cloudsc2_tl_chunk_kernel", f"IfLb0ELb1ELb0ELi{c}E"),
                   ms["tl"])),
        record("din_chunk", "cloudsc2_tl_din_chunk",
               "cloudsc2jax/pallas/tlad_kernel.py:170",
               by_chunk["din_chunk"][first], **chunk_extra(
                   "din_chunk", "cloudsc2_tl_din_chunk",
                   lambda c: ("cloudsc2_tl_chunk_kernel", f"IfLb0ELb0ELb1ELi{c}E"),
                   ms["din"])),
        record("fwd_chunk", "cloudsc2_fwd_chunk", "cloudsc2jax/pallas/tlad_kernel.py:405",
               by_chunk["fwd_chunk"][first], **chunk_extra(
                   "fwd_chunk", "cloudsc2_fwd_chunk",
                   lambda c: ("cloudsc2_fwd_chunk_kernel", f"IfLb0ELi{c}E"),
                   ms["fwd"])),
        record("tl_bf16", "cloudsc2_tl_enc_bf16", "cloudsc2jax/pallas/tlad_kernel.py:170",
               ms["tl_bf16"], ms_noprim=ms["tl_bf16_noprim"],
               ms_int16_same_run=ms["tl_enc"], ms_int16_noprim_same_run=ms["tl_enc_noprim"],
               **_ptxas_of("cloudsc2_tl_enc_bf16", "cloudsc2_tl_enc_bf16_kernel",
                           "Lb0ELb1ELb1E", "ILj16381E")),
        record("ad_bf16", "cloudsc2_ad_enc_bf16", "cloudsc2jax/pallas/tlad_kernel.py:454",
               ms["ad_bf16"], ms_int16_same_run=ms["ad_enc"],
               identity_f32=rel,
               **_ptxas_of("cloudsc2_ad_enc_bf16", "cloudsc2_ad_enc_bf16_kernel",
                           "Lb0ELb1E", "ILj16381E")),
    ]


# The comparisons of phases 6, 9, 12, 15, 18 and 21 and the truth path's runs
# of phase 20 are bound by the host (a plain TL or AD sweep is ~140,000 small
# launches), so each runs in a process of its own beside the main process's
# phases 3, 4, 7 and 10; nothing is timed for the records until all of them
# have ended.
COMPARISONS = {
    "tlad": compare_tlad,
    "variants": compare_variants,
    "experiments": compare_experiments,
    "nl_experiments": compare_nl_experiments,
    "chunked": compare_chunked,
    "truth": compare_truth,
    "schedules": compare_schedules,
}
# where a comparison's process leaves its output (<name>.log) and its result
# (<name>.json): under the checkout's build directory
WORK_DIR = ROOT / "build" / "chip_smoke"


def _compare_worker(name: str) -> int:
    """One comparison, in a process of its own: prints what the phase prints
    and writes its result to ``WORK_DIR/<name>.json``."""
    from cloudsc2jax_torch.state import Cloudsc2State

    state = Cloudsc2State.load(FIXTURES / "input.npz")
    result = COMPARISONS[name](state, state.params)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    (WORK_DIR / f"{name}.json").write_text(json.dumps(result))
    return 0


def _start_comparisons() -> dict:
    """Start every comparison; returns name -> (process, its open log)."""
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in COMPARISONS:
        (WORK_DIR / f"{name}.json").unlink(missing_ok=True)
        log = open(WORK_DIR / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--compare", name],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        started[name] = (proc, log)
    return started


def _join_comparisons(started: dict) -> dict:
    """Wait for the comparisons, print their output, and return their
    results; raises if one failed."""
    results, failed = {}, []
    for name, (proc, log) in started.items():
        rc = proc.wait()
        log.close()
        print((WORK_DIR / f"{name}.log").read_text(), end="")
        result = WORK_DIR / f"{name}.json"
        if rc != 0 or not result.is_file():
            failed.append(f"{name} (exit code {rc})")
        else:
            results[name] = json.loads(result.read_text())
    if failed:
        raise AssertionError("comparison failed: " + ", ".join(failed))
    return results


def _prelude_record(x, pre, params, ms: float, library_ms: float,
                    launches: int) -> dict:
    """The prelude's kernel's record at the inputs ``x`` (``pre`` their
    prelude): its bound from the rows it must move (pt's and ten_t's rows
    of the eta band's hull, ceta's band levels, the tropopause eta
    written), held to the bytes of those slices of the run's own tensors,
    and six operations a level and column (a multiply, an add, three
    compares and a max)."""
    from cloudsc2jax_torch import roofline
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import tropopause_hull

    nlev, ncol = x.pt.shape
    k_lo, k_hi = tropopause_hull(params, x.pt.dtype)
    levels = k_hi - k_lo + 1
    rows = 2 * (levels + 1) + 1
    moved = _nbytes(x.pt[k_lo:k_hi + 2], x.ten_t[k_lo:k_hi + 2], pre.ztrpaus,
                    pre.ceta[k_lo:k_hi + 1])
    b = roofline.bound_of(rows * ncol * 4 + levels * 4, 6 * levels * ncol)
    if b["bytes"] != moved:
        raise AssertionError(f"cloudsc2_prelude: {b['bytes']} bytes counted, the "
                             f"run's tensors {moved}")
    return {
        **b,
        "name": "cloudsc2_prelude",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/cloudsc2_prelude.cu",
        "replaces": "cloudsc2jax/pallas/cloudsc2_kernel.py:590",
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": ms,
        "library_ms": library_ms,
        "hull": [k_lo, k_hi],
        "ncol": ncol,
        "nlev": nlev,
    }


def _in_place_streams(out):
    """``out`` with its flux streams copied into rows 1.. of new flux
    fields, as a sweep given ``flux_slots`` writes them: ``(streams,
    flux)``."""
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import flux_rows, flux_slots

    flux = flux_rows(out.rfln)
    slots = flux_slots(flux)
    for name, slot in slots.items():
        slot.copy_(getattr(out, name))
    return out._replace(**slots), flux


def _check_contract(streams, in_place, params) -> None:
    """Phase 5: the contract's kernel, as a copy and in place, with and
    without the seeds, bit for bit ``plain_contract`` (the PyTorch
    expressions) on the same card tensors, the signs of zeros included."""
    import torch

    from cloudsc2jax_torch.kernels.cloudsc2_kernel import assemble_contract, plain_contract

    for out, (lm, flux) in zip(streams, in_place):
        want, want_seeds = plain_contract(out, params, seeds=True)
        for got, seeds in (assemble_contract(out, params, seeds=True),
                           assemble_contract(lm, params, flux=flux, seeds=True)):
            for a, b in zip((*got, *seeds), (*want, *want_seeds)):
                if not (torch.equal(a, b) and torch.equal(a.signbit(), b.signbit())):
                    raise AssertionError("[5] the contract's kernel is not "
                                         "plain_contract bit for bit")
    print(f"[5] contract: the kernel bit for bit plain_contract on {len(streams)} "
          f"sets, as a copy and in place, with the seeds")


def _contract_record(out, flux, params, ms: dict) -> dict:
    """The contract's kernel's record at the in-place streams ``out`` (rows
    1.. of ``flux``), as ``run_nl(backend="kernels")`` runs it: its bound
    from ``contract_bytes`` (the flux rows read, the top rows and the
    enthalpy fluxes written), held to the bytes of those tensors, and one
    operation an enthalpy value; its registers from ptxas."""
    from cloudsc2jax_torch import roofline
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import assemble_contract, contract_bytes

    nlev, ncol = out.rfln.shape
    res, _ = assemble_contract(out, params, flux=flux)
    moved = _nbytes(out.rfln, out.sfln, flux.pfplsl[:1], flux.pfplsn[:1],
                    res.pfhpsl, res.pfhpsn)
    b = roofline.bound_of(contract_bytes(nlev, ncol, out.rfln.element_size(),
                                         in_place=True, seeds=False, kernel=True),
                          2 * (nlev + 1) * ncol)
    if b["bytes"] != moved:
        raise AssertionError(f"cloudsc2_contract: {b['bytes']} bytes counted, the "
                             f"run's tensors {moved}")
    return {
        **b,
        "name": "cloudsc2_contract",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/cloudsc2_contract.cu",
        "replaces": "none: the contract's assembly, left to XLA",
        "max_abs_err": 0.0,
        "ms": ms["in_place_ms"],
        **ms,
        "ptxas": build.ptxas_report("cloudsc2_contract"),
        "ncol": ncol,
        "nlev": nlev,
    }


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if argv[:1] == ["--compare"]:
        return _compare_worker(argv[1])
    if argv == ["--rank-worker"]:
        return _rank_worker()
    if argv == ["--bench-worker"]:
        return _bench_worker()
    serial = argv == ["--serial"]
    if argv and not serial:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()

    from cloudsc2jax_torch.bw_probe import KERNEL_MIXES, probe_defines
    from cloudsc2jax_torch.drivers import run_nl
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
        assemble_contract,
        cloudsc2_nl_reference,
        kernel_prelude,
        launch_cloudsc2_nl,
        level_scalars,
        plain_contract,
        tropopause_eta_lm,
        unblock_outputs,
    )
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs
    from cloudsc2jax_torch.state import Cloudsc2State

    # -- 1. card
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = _nvidia_smi("name,power.limit")
    print(f"[1] card: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} device(s))")
    print(card)

    # -- 2. build, every nvcc run together: the shipped libraries and the
    # probe's mixes
    t0 = time.perf_counter()
    specs = [(lib, (), ()) for lib in LIBRARIES if lib != "bw_probe"] + [STD_TL]
    for _, reads, writes, _, weighted in KERNEL_MIXES:
        specs += [("bw_probe", probe_defines(reads, writes, c), ())
                  for c in ((0, 0), weighted) if c is not None]
    build.load_libraries(specs)
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.1f} s for {len(specs)} libraries "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for lib, defines, flags in specs:
        tag = " ".join([*(d.split("_", 2)[2] for d in defines),
                        *(f for f in build._key((lib, defines, flags))[2]
                          if not f.startswith("-I"))])
        for e in build.ptxas_report(lib, defines, flags):
            print(f"    ptxas {tag} "
                  f"{e['entry']}: {e.get('registers')} registers, "
                  f"{e.get('stack_bytes')} B stack, "
                  f"{e.get('spill_store_bytes')} B spill stores, "
                  f"{e.get('spill_load_bytes')} B spill loads")
    check_exact_sass(specs)
    # ptxas reports the fused kernel's launch count; each role's own
    # registers and spills are read from its region of the SASS
    fused_roles = {}
    for e in build.ptxas_report("cloudsc2_tlad_fused"):
        roles = build.role_registers("cloudsc2_tlad_fused", [e["entry"]])
        fused_roles[e["entry"]] = roles
        print(f"    SASS {e['entry']}: launch {e.get('registers')} registers; "
              + "; ".join(f"{role.upper()} role {r['registers']} registers, "
                          f"{r['stl']} STL, {r['ldl']} LDL"
                          for role, r in roles.items() if role != "setmaxreg")
              + f" ({roles['setmaxreg']} SETMAXREG)")

    state = Cloudsc2State.load(FIXTURES / "input.npz")
    params = state.params
    t_phase = _lap("1-2", t_start)
    if serial:
        # every phase in this process, to measure what the fan-out saves
        nl_compare = _nl_compare_and_cli(state, params)
        tlad_launches = cli_tlad()
        variants_ran = cli_variants(state, params)
        t_phase = _lap("3-4, 7, 10", t_phase)
        compared = {name: fn(state, params) for name, fn in COMPARISONS.items()}
        t_phase = _lap("6, 9, 12, 15, 18, 20a-c, 21 in this process", t_phase)
    else:
        comparisons = _start_comparisons()
        try:
            nl_compare = _nl_compare_and_cli(state, params)
            tlad_launches = cli_tlad()
            variants_ran = cli_variants(state, params)
            t_phase = _lap("3-4, 7, 10 in the main process", t_phase)
            compared = _join_comparisons(comparisons)
        finally:
            for proc, log in comparisons.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        t_phase = _lap("6, 9, 12, 15, 18, 20a-c, 21 in their processes, waited for",
                       t_phase)
    worst_abs, worst_rel, main_launches, prelude_launches = nl_compare
    # -- 5. timing at the headline size, f32, distinct inputs per call
    ncol = TIMING_NCOL
    base = state.device_kernel_inputs(ncol, dtype=torch.float32, device="cuda")
    sets = [base] + [Cloudsc2Inputs(*(None if x is None else x.roll(s, dims=1)
                                      for x in base))
                     for s in (37, 71)]
    for i, s in enumerate(sets):
        _check_prelude(s, params, f"[5] set {i} at {ncol} columns f32")
    pres = [kernel_prelude(s, params) for s in sets]
    kernel_ms = _time_ms(
        lambda i, p: launch_cloudsc2_nl(i, p, params), list(zip(sets, pres)), 30)
    prelude_ms = _time_ms(lambda i: kernel_prelude(i, params),
                          [(s,) for s in sets], 30)
    ceta = level_scalars(params, base.pt)[0]
    prelude_plain_ms = _time_ms(
        lambda i: tropopause_eta_lm(i.pt + params.ptsphy * i.ten_t, ceta),
        [(s,) for s in sets], 30)
    run_nl_ms = _time_ms(lambda i: run_nl(i, params), [(s,) for s in sets], 30)
    streams = [run_nl(s, params) for s in sets]
    contract_ms = _time_ms(lambda o: unblock_outputs(o, params),
                           [(o,) for o in streams], 30)
    in_place = [_in_place_streams(o) for o in streams]
    contract = {
        "in_place_ms": _time_ms(lambda o, f: assemble_contract(o, params, flux=f),
                                in_place, 30),
        "seeds_ms": _time_ms(
            lambda o, f: assemble_contract(o, params, flux=f, seeds=True), in_place, 30),
        "copy_ms": contract_ms,
        "library_ms": _time_ms(lambda o: plain_contract(o, params),
                               [(o,) for o in streams], 30),
        "library_seeds_ms": _time_ms(lambda o: plain_contract(o, params, seeds=True),
                                     [(o,) for o in streams], 30),
    }
    _check_contract(streams, in_place, params)
    contract_record = _contract_record(*in_place[0], params, contract)
    del streams, in_place
    views = [Cloudsc2Inputs(*(None if x is None else x.T for x in s)) for s in sets]
    launches = assemble_contract.launches
    run_nl_kernels_ms = _time_ms(lambda i: run_nl(i, params, backend="kernels"),
                                 [(v,) for v in views], 30)
    contract_record["launches"] = assemble_contract.launches - launches
    if contract_record["launches"] != 30 + len(views):
        raise AssertionError(f"[5] run_nl(backend='kernels'): "
                             f"{contract_record['launches']} contract launches in "
                             f"{30 + len(views)} calls")
    del views
    plain_ms = _time_once_ms(lambda i: cloudsc2_nl_reference(i, params), sets[0])
    nlev = base.pt.shape[0]
    nbytes = (15 * nlev + 1 + 8 * nlev) * ncol * 4
    for label, ms in (("kernel", kernel_ms), ("pre-kernel", prelude_ms),
                      ("pre-kernel's plain expression", prelude_plain_ms),
                      ("run_nl (stream contract: pre-kernel + kernel)", run_nl_ms),
                      ("output contract (unblock_outputs, once per validation)",
                       contract_ms),
                      ("output contract in place (run_nl(backend='kernels'))",
                       contract["in_place_ms"]),
                      ("output contract in place with the seeds (run_tlad's tangent)",
                       contract["seeds_ms"]),
                      ("output contract by PyTorch's expressions (plain_contract)",
                       contract["library_ms"]),
                      ("the same with the seeds", contract["library_seeds_ms"]),
                      ("run_nl(backend='kernels') on transposed views", run_nl_kernels_ms),
                      ("plain version", plain_ms)):
        print(f"[5] {label}: {ms:.4f} ms/call, {ncol / (ms * 1e-3):.4e} cols/s"
              f" at {ncol} columns f32")
    print(f"[5] kernel bytes/call {nbytes} ({nbytes / 1e9:.4f} GB), attained "
          f"{nbytes / (kernel_ms * 1e-3) / 1e9:.1f} GB/s")
    print(f"[5] after timing: {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    nl_record = {
        **_bound("cloudsc2_nl", ncol, nlev,
                 _nbytes(sets[0], pres[0]) + 8 * _nbytes(base.pt)),
        "name": "cloudsc2_nl",
        "route": "cuda",
        "source": "cloudsc2jax_torch/csrc/cloudsc2_nl.cu",
        "replaces": "cloudsc2jax/pallas/cloudsc2_kernel.py:348",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_err_f32": worst_rel["float32"],
        "max_rel_err_f64": worst_rel["float64"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "prelude_ms": prelude_ms,
        "run_nl_ms": run_nl_ms,
        "contract_ms": contract_ms,
        "run_nl_kernels_ms": run_nl_kernels_ms,
        "ncol": ncol,
        "build_s": build_s,
    }
    prelude_record = _prelude_record(base, pres[0], params, prelude_ms, prelude_plain_ms,
                                     prelude_launches + tlad_launches["prelude"])
    del sets, pres, base
    t_phase = _lap("5", t_phase)
    tlad_records = time_tlad(state, params, compared["tlad"], tlad_launches)
    t_phase = _lap("8", t_phase)
    test_records = time_variants(state, params, compared["variants"], variants_ran,
                                 ad_record=tlad_records[1])
    t_phase = _lap("11", t_phase)
    ab_ran = cli_experiments()
    ab_records = time_experiments(state, params, compared["experiments"], ab_ran,
                                  fused_roles)
    tlad_records[0]["launches_kernel_ab"] = ab_ran["launches"]["tl"]
    tlad_records[1]["launches_kernel_ab"] = ab_ran["launches"]["ad"]
    t_phase = _lap("13-14", t_phase)
    nl_ran = cli_nl_experiments(state, params)
    nl_records = time_nl_experiments(state, params, compared["nl_experiments"],
                                     nl_ran)
    probes = nl_ran["probes"]
    t_phase = _lap("16-17", t_phase)
    chunked = chunked_and_bench(state, params)
    for rec, name in ((nl_record, "nl"), (tlad_records[0], "tl"),
                      (tlad_records[1], "ad")):
        rec["launches_chunked"] = chunked["launches"][name]
    nl_record["chunked_rel_err"] = compared["chunked"]["rel"]["nl"]
    tlad_records[1]["chunked_rel_err"] = compared["chunked"]["rel"]["tlad"]
    t_phase = _lap("18", t_phase)
    torch.cuda.empty_cache()
    mp = multi_process(chunked["sums"])
    for rec, name in ((nl_record, "nl"), (tlad_records[0], "tl"),
                      (tlad_records[1], "ad")):
        run = 0 if name == "nl" else 1
        rec["launches_two_ranks"] = [r["runs"][run]["launches"][name]
                                     for r in mp["ranks"]]
    nl_record["two_ranks"] = mp["timing"][0]
    tlad_records[1]["two_ranks"] = mp["timing"][1]
    t_phase = _lap("19", t_phase)
    torch.cuda.empty_cache()
    schedule_records = schedules_main(state, params, compared["schedules"])
    t_phase = _lap("21 (main process)", t_phase)
    records = [nl_record, *tlad_records, *test_records, *ab_records, *nl_records,
               *schedule_records]
    # phase 20's bench modes run in processes of their own, on the same card
    reserved = torch.cuda.memory_reserved() / 1e9
    torch.cuda.empty_cache()
    print(f"[20] this process held {reserved:.2f} GB of the card in its cache, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB after emptying it")
    modes = phase_20(records, probes, params.nlev)
    res_record = next(r for r in nl_records if r["name"] == "cloudsc2_nl_res")
    res_record["launches_bench_resident"] = modes["resident"]["launches"]
    nl_record["launches_bench_standard"] = modes["standard"]["launches"]
    truth = compared["truth"]
    print("[20] " + json.dumps({"truth_path": truth["runs"], "cli_s": truth["cli_s"],
                                "bench_truth": truth["bench"],
                                "bench_modes": {k: v["record"] for k, v in modes.items()},
                                "card": truth["card"]}))
    _lap("20", t_phase)
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    for rec in records:
        # the window-matched probe's rate at this kernel's mix, for its bytes
        mix = KERNEL_MIX[rec["name"]]
        plain = probes[mix, False]
        rec["ceiling_mix"] = plain["windows"] + (" reversed" if plain["rev"] else "")
        rec["ceiling_ms"] = rec["bytes"] / (plain["attained_gbps"] * 1e9) * 1e3
        if (mix, True) in probes:
            rec["weighted_probe_ms"] = probes[mix, True]["ms_per_call"]
        print(f"ceiling {rec['name']}: {rec['ms']:.4f} ms against "
              f"{rec['ceiling_ms']:.4f} ms at {rec['ceiling_mix']} "
              f"({rec['ceiling_ms'] / rec['ms']:.1%}), bound "
              f"{rec['bound_ms']:.4f} ms")
    for rec in (prelude_record, contract_record):
        print(f"bound {rec['name']}: {rec['ms']:.4f} ms against "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"({rec['bound_ms'] / rec['ms']:.1%}), PyTorch's expressions "
              f"{rec['library_ms']:.4f} ms")
    records += [prelude_record, contract_record]

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
