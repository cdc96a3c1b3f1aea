// CLOUDSC2 tangent-linear sweep: one thread owns one column.  Shared by
// cloudsc2_tl.cu (increments formed in registers) and cloudsc2_tl_din.cu
// (increments streamed), which are built as two libraries so that their
// nvcc runs overlap.
//
// Replaces the TPU kernel `_tl_kernel` (cloudsc2jax/pallas/tlad_kernel.py:170)
// in both of its modes, as `cloudsc2_pallas_tl` (:272) runs them:
//
// * `dscale` (the work unit, `dscale=0.01, save_checkpoints=True,
//   write_primal=...`): the increments are never streamed, dx = dscale*x is
//   formed in registers for the 17 level values and paph_sfc, and the 3
//   carry-in checkpoints are written for the reverse sweep.
// * `d_inputs` (the standalone TL, :196-199, 240-242, 348-361): the 17 level
//   tangents are READ from a second set of 16 streams laid out like the
//   inputs (d_plu at k+1 clamped like plu, d_paph at k and k+1 with the k+1
//   row carried over like paph), and the paph_sfc tangent is d_paph's last
//   row.  No checkpoints are written.
//
// In both the tropopause eta has a zero tangent (tlad_kernel.py:238-245).
// The statements of one level, primal and tangent, are generated from the
// port's level body by cloudsc2jax_torch/kernels/emit.py (`torch.func.jvp`
// of `level_physics`) into cloudsc2_tl_level.cuh, once per setting of
// (levapls2 or ldrain1d, lregcl); this file is the hand-written schedule
// around them.
//
// Schedule.  The TPU grid ran (column block, level) in order and carried
// the primal and tangent carries in VMEM scratch.  Here each thread loops
// over the levels of its own column with rfl/sfl/covptot and their tangents
// in registers.  Arrays are levels-major (nlev, ncol) without padding, so a
// warp's read of one level is one coalesced row segment; the ragged last
// block masks its tail.  paph(k+1) of level k is kept as paph(k) of level
// k+1, and plu is read only at k+1 (clamped at the last level, as
// `_level_index_maps` does), so each of the 16 input streams (pqs included)
// is read once per level, and each of the 16 tangent streams likewise.
//
// Traffic per level and column.  dscale: 16 reads; 8 tangent, 3 checkpoint
// and, with WRITE_PRIMAL, 8 primal writes.  d_inputs: 32 reads; 8 tangent
// and 8 primal writes.  The level body is ~1,000 statements, about 3x the
// NL body, for 35-48 values moved; the design moves each byte once and
// keeps everything else in registers.  What bounds it on this card is not
// bytes: on an NVIDIA H100 (700 W) at 327,680 f32 columns both modes took
// 4.72 ms, though d_inputs reads 2.3 GB more, against a bytes bound of 1.9
// and 2.6 ms, at 128 registers and 16 warps per SM, while the body holds
// at most ~60 values live (PERF.md): declared with no minimum of blocks,
// the kernel let ptxas spend registers on instruction-level parallelism
// and pay for it in warps.  Each mode now asks for a minimum of blocks of
// 128 threads per SM (CLOUDSC2_TL_MIN_BLOCKS_F32, CLOUDSC2_TL_DIN_MIN_
// BLOCKS_F32), chosen by probes/tlad_budget.py, which builds each budget
// through these defines.  Staging the next levels' rows in shared memory by
// `cp.async` while a level computes lost or tied at every budget, so the
// loads stay plain (PERF.md).
//
// Two more kernels run this schedule.  The int16-encoded sweep
// (cloudsc2_tl_enc.cu) differs only in how a stream value is loaded: the
// `Load` policy of cloudsc2_load.cuh.  The single-launch TL+AD unit
// (cloudsc2_tlad_fused.cu) calls `sweep_column` in its TL warpgroups, one
// tile of 128 columns at a time, and sends the checkpoints to a ring slot
// in a scratch instead of to (nlev, ncol) streams (`ckpt_stride`,
// `ckpt_col`).
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// fast math.  Params arrive as host doubles; the constants Python would fold
// in double are folded on the host by Level<EVAP, LREGCL>::constants and
// rounded to T once.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cloudsc2_load.cuh"
#include "cloudsc2_tl_level.cuh"

#ifndef CLOUDSC2_TL_MIN_BLOCKS_F32
#define CLOUDSC2_TL_MIN_BLOCKS_F32 8
#endif
#ifndef CLOUDSC2_TL_DIN_MIN_BLOCKS_F32
#define CLOUDSC2_TL_DIN_MIN_BLOCKS_F32 7
#endif

namespace cloudsc2_tl {

constexpr int kThreads = 128;
constexpr int kFields = 14;  // level rows read at k; then plu, paph

// Pointer order of Args::in (TL_STREAMS in kernels/tlad_kernel.py).
enum Stream {
  S_PT, S_PQ, S_PQS, S_PAP, S_PL, S_PI, S_PLUDE, S_PMFU, S_PMFD,
  S_TEN_T, S_TEN_Q, S_TEN_L, S_TEN_I, S_PSUPSAT, S_PLU, S_PAPH,
  S_CETA, S_ZSCALM, S_ZTRPAUS, S_PAPH_SFC,
  N_STREAM
};

// Args::din (TL_TANGENT_STREAMS): the tangents of the first 16 streams, in
// the same order and shapes.
constexpr int kTangentStreams = S_PAPH + 1;

// Blocks of kThreads per SM the register budget must allow (f32), by mode.
// The f64 kernels run a benchmarked deployment (the cell tlad.f64) whose
// budgets have not been chosen yet, so they are left unbounded.
template <typename T, bool D_INPUTS>
constexpr int kMinBlocks =
    sizeof(T) != 4 ? 1 : D_INPUTS ? CLOUDSC2_TL_DIN_MIN_BLOCKS_F32
                                  : CLOUDSC2_TL_MIN_BLOCKS_F32;

// Pointer order of Args::out (TL_OUTPUTS): 8 tangents, 3 carry-in
// checkpoints (null with D_INPUTS), 8 primal outputs (null unless
// WRITE_PRIMAL).
enum Output {
  O_TANGENT = 0, O_CKPT = 8, O_PRIMAL = 11,
  N_OUTPUT = 19
};

template <typename T>
struct Args {
  const T* in[N_STREAM];
  const T* din[kTangentStreams];  // D_INPUTS only
  T* out[N_OUTPUT];
  T dscale;  // unused with D_INPUTS
  T k[kMaxConsts];
  // cloudsc2_load::EncodedLevels only: the level-major (table_rows, 16, 2)
  // [scale, offset] table on the device and the streams that hold int16
  // payloads, bit j for in[j]
  const float2* table;
  int table_rows;
  unsigned enc_mask;
};

// The level loop of one column.  Checkpoint j of level k goes to
// out[O_CKPT + j][k * ckpt_stride + ckpt_col]: (ncol, col) for the
// checkpoint streams of the two-kernel unit.
template <typename T, bool EVAP, bool LREGCL, bool WRITE_PRIMAL, bool D_INPUTS,
          typename Load>
__device__ __forceinline__ void sweep_column(const Args<T>& a, const int ncol,
                                             const int nlev, const int64_t col,
                                             const int64_t ckpt_stride,
                                             const int64_t ckpt_col) {
  const T dscale = a.dscale;
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  const T dpaph_sfc =
      D_INPUTS ? __ldg(a.din[S_PAPH] + int64_t(nlev) * ncol + col)
               : dscale * c[1];
  T r[3] = {T(0.0), T(0.0), T(0.0)};
  T dr[3] = {T(0.0), T(0.0), T(0.0)};
  T paph_lo = Load::template value<T>(
      a, S_PAPH, 0, Load::template fetch<T>(a, S_PAPH, col));
  T dpaph_lo = D_INPUTS ? __ldg(a.din[S_PAPH] + col) : T(0.0);

  for (int k = 0; k < nlev; ++k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
    const int64_t i1 = int64_t(k1) * ncol + col;
    const int64_t ihi = int64_t(k + 1) * ncol + col;
    T x[17];
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = Load::template fetch<T>(a, j, i);
    x[14] = Load::template fetch<T>(a, S_PLU, i1);
    x[16] = Load::template fetch<T>(a, S_PAPH, ihi);
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = Load::template value<T>(a, j, k, x[j]);
    x[14] = Load::template value<T>(a, S_PLU, k1, x[14]);
    x[15] = paph_lo;
    x[16] = Load::template value<T>(a, S_PAPH, k + 1, x[16]);
    T dx[17];
    if (D_INPUTS) {
#pragma unroll
      for (int j = 0; j < kFields; ++j) dx[j] = __ldg(a.din[j] + i);
      dx[14] = __ldg(a.din[S_PLU] + i1);
      dx[15] = dpaph_lo;
      dx[16] = __ldg(a.din[S_PAPH] + ihi);
    } else {
#pragma unroll
      for (int j = 0; j < 17; ++j) dx[j] = dscale * x[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a.out[O_CKPT + j][int64_t(k) * ckpt_stride + ckpt_col] = r[j];
      }
    }

    T y[8], ry[3], dy[8], dry[3];
    Level<EVAP, LREGCL>::run(a.k, __ldg(a.in[S_CETA] + k),
                             __ldg(a.in[S_ZSCALM] + k), k < nlev - 1, x, c, r,
                             dx, dpaph_sfc, dr, y, ry, dy, dry);
#pragma unroll
    for (int j = 0; j < 8; ++j) a.out[O_TANGENT + j][i] = dy[j];
    if (WRITE_PRIMAL) {
#pragma unroll
      for (int j = 0; j < 8; ++j) a.out[O_PRIMAL + j][i] = y[j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[j] = ry[j];
      dr[j] = dry[j];
    }
    paph_lo = x[16];
    dpaph_lo = dx[16];
  }
}

// One thread per column, the ragged last block masked.
template <typename T, bool EVAP, bool LREGCL, bool WRITE_PRIMAL, bool D_INPUTS,
          typename Load>
__device__ __forceinline__ void sweep(const Args<T>& a, const int ncol,
                                      const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<T, EVAP, LREGCL, WRITE_PRIMAL, D_INPUTS, Load>(a, ncol, nlev,
                                                              col, ncol, col);
}

template <typename T, bool EVAP, bool LREGCL, bool WRITE_PRIMAL, typename Load>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, false>))
    cloudsc2_tl_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  sweep<T, EVAP, LREGCL, WRITE_PRIMAL, false, Load>(a, ncol, nlev);
}

template <typename T, bool EVAP, bool LREGCL>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, true>))
    cloudsc2_tl_din_kernel(const __grid_constant__ Args<T> a, const int ncol,
                           const int nlev) {
  sweep<T, EVAP, LREGCL, true, true, cloudsc2_load::Exact>(a, ncol, nlev);
}

// Folds the level body's constants in double and rounds them to T once.
template <typename T, bool EVAP, bool LREGCL>
void fill_constants(Args<T>& a, const double* params) {
  double k[kMaxConsts];
  Level<EVAP, LREGCL>::constants(params, k);
  for (int j = 0; j < Level<EVAP, LREGCL>::kNumConsts; ++j) a.k[j] = T(k[j]);
}

template <typename T, bool EVAP, bool LREGCL, bool D_INPUTS>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   bool write_primal, cudaStream_t s) {
  using Load = cloudsc2_load::Exact;
  fill_constants<T, EVAP, LREGCL>(a, params);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  if constexpr (D_INPUTS) {
    cloudsc2_tl_din_kernel<T, EVAP, LREGCL><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else if (write_primal) {
    cloudsc2_tl_kernel<T, EVAP, LREGCL, true, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_tl_kernel<T, EVAP, LREGCL, false, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

static_assert((1u << S_PQ | 1u << S_PLU | 1u << S_PAPH) ==
                  cloudsc2_load::kNeverEncoded,
              "cloudsc2_load.cuh numbers the streams differently");

// Fills Args from the launcher's pointer arrays; returns a cudaError_t.
// `din` is read only with D_INPUTS, where the primal streams are always
// written and no checkpoint is.  `table` and `enc_mask` are the encoded
// kernels' (cloudsc2_load::EncodedLevels); the mask may set none of
// cloudsc2_load::kNeverEncoded.
template <typename T, bool D_INPUTS>
int fill_args(Args<T>& a, const void* const* in, const void* const* din,
              void* const* out, double dscale, int ncol, int nlev,
              int write_primal, const void* table = nullptr,
              unsigned enc_mask = 0u) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  if (D_INPUTS && !write_primal) return int(cudaErrorInvalidValue);
  if ((enc_mask & cloudsc2_load::kNeverEncoded) || enc_mask >> kTangentStreams) {
    return int(cudaErrorInvalidValue);
  }
  a.table = static_cast<const float2*>(table);
  a.table_rows = nlev + 1;
  a.enc_mask = enc_mask;
  for (int j = 0; j < N_STREAM; ++j) a.in[j] = static_cast<const T*>(in[j]);
  if (D_INPUTS) {
    for (int j = 0; j < kTangentStreams; ++j) {
      a.din[j] = static_cast<const T*>(din[j]);
      if (a.din[j] == nullptr) return int(cudaErrorInvalidValue);
    }
  }
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  for (int j = 0; j < N_OUTPUT; ++j) {
    const bool needed = j < O_CKPT || (j < O_PRIMAL ? !D_INPUTS : write_primal != 0);
    if (needed && a.out[j] == nullptr) return int(cudaErrorInvalidValue);
  }
  a.dscale = T(dscale);
  return 0;
}

// Fills Args from the launcher's pointer arrays and picks the variant of
// the exact kernels.
template <typename T, bool D_INPUTS>
int launch(const void* const* in, const void* const* din, void* const* out,
           const double* params, double dscale, int ncol, int nlev, int evap,
           int lregcl, int write_primal, void* stream) {
  Args<T> a = {};
  const int err =
      fill_args<T, D_INPUTS>(a, in, din, out, dscale, ncol, nlev, write_primal);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wp = write_primal != 0;
  if (evap) {
    return lregcl ? launch_variant<T, true, true, D_INPUTS>(a, params, ncol, nlev, wp, s)
                  : launch_variant<T, true, false, D_INPUTS>(a, params, ncol, nlev, wp, s);
  }
  return lregcl ? launch_variant<T, false, true, D_INPUTS>(a, params, ncol, nlev, wp, s)
                : launch_variant<T, false, false, D_INPUTS>(a, params, ncol, nlev, wp, s);
}

// ---------------------------------------------------------------------------
// C levels a step: `_tl_kernel` with `chunk` > 1 (tlad_kernel.py:170, the
// loop :220, the reads `_chunk_reads` :105), as `cloudsc2_pallas_tl(...,
// chunk_levels=C)` (:284) runs it in both modes.  The primal streams are
// always written (JAX refuses write_primal=False with chunks, :321).
//
// A step first issues the loads of each of its C levels (16 values a level,
// and 16 more with D_INPUTS), the counterpart of the TPU's C-level DMA
// window, then runs the C level bodies in ascending order, each on the
// values at the head of the window, which moves up one level after each
// body.  The bodies are one loop of their own that is not unrolled, so the
// window costs registers (16 or 32 (C-1) values live across a body) and not
// a copy of the body per level.  The last, partial step (137 is prime)
// loads and runs only the levels that exist.  plu(k+1) is clamped at the
// last level; paph(k+1) of one level is paph(k) of the next, carried from
// the window's previous level or the previous step's last.  Every level
// runs the C = 1 kernel's body on the same values in the same order, so the
// results are that kernel's bit for bit.
template <typename T, bool EVAP, bool LREGCL, bool D_INPUTS, int C>
__device__ __forceinline__ void sweep_column_chunked(const Args<T>& a,
                                                     const int ncol,
                                                     const int nlev,
                                                     const int64_t col) {
  const T dscale = a.dscale;
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  const T dpaph_sfc =
      D_INPUTS ? __ldg(a.din[S_PAPH] + int64_t(nlev) * ncol + col)
               : dscale * c[1];
  T r[3] = {T(0.0), T(0.0), T(0.0)};
  T dr[3] = {T(0.0), T(0.0), T(0.0)};
  T paph_lo = __ldg(a.in[S_PAPH] + col);
  T dpaph_lo = D_INPUTS ? __ldg(a.din[S_PAPH] + col) : T(0.0);

  for (int k0 = 0; k0 < nlev; k0 += C) {
    const int n = nlev - k0 < C ? nlev - k0 : C;  // levels k0 ... k0 + n - 1
    // per level: the 14 level rows, plu(k+1), paph(k+1)
    T w[C][kTangentStreams];
    T dw[D_INPUTS ? C : 1][kTangentStreams];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (m < n) {
        const int k = k0 + m;
        const int64_t i = int64_t(k) * ncol + col;
        const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
        const int64_t i1 = int64_t(k1) * ncol + col;
        const int64_t ihi = int64_t(k + 1) * ncol + col;
#pragma unroll
        for (int j = 0; j < kFields; ++j) w[m][j] = __ldg(a.in[j] + i);
        w[m][14] = __ldg(a.in[S_PLU] + i1);
        w[m][15] = __ldg(a.in[S_PAPH] + ihi);
        if constexpr (D_INPUTS) {
#pragma unroll
          for (int j = 0; j < kFields; ++j) dw[m][j] = __ldg(a.din[j] + i);
          dw[m][14] = __ldg(a.din[S_PLU] + i1);
          dw[m][15] = __ldg(a.din[S_PAPH] + ihi);
        }
      }
    }
#pragma unroll 1
    for (int m = 0; m < n; ++m) {
      const int k = k0 + m;
      const int64_t i = int64_t(k) * ncol + col;
      T x[17];
#pragma unroll
      for (int j = 0; j < 15; ++j) x[j] = w[0][j];
      x[15] = paph_lo;
      x[16] = w[0][15];
      T dx[17];
      if constexpr (D_INPUTS) {
#pragma unroll
        for (int j = 0; j < 15; ++j) dx[j] = dw[0][j];
        dx[15] = dpaph_lo;
        dx[16] = dw[0][15];
      } else {
#pragma unroll
        for (int j = 0; j < 17; ++j) dx[j] = dscale * x[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) a.out[O_CKPT + j][i] = r[j];
      }

      T y[8], ry[3], dy[8], dry[3];
      Level<EVAP, LREGCL>::run(a.k, __ldg(a.in[S_CETA] + k),
                               __ldg(a.in[S_ZSCALM] + k), k < nlev - 1, x, c, r,
                               dx, dpaph_sfc, dr, y, ry, dy, dry);
#pragma unroll
      for (int j = 0; j < 8; ++j) a.out[O_TANGENT + j][i] = dy[j];
#pragma unroll
      for (int j = 0; j < 8; ++j) a.out[O_PRIMAL + j][i] = y[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        r[j] = ry[j];
        dr[j] = dry[j];
      }
      paph_lo = x[16];
      dpaph_lo = dx[16];
#pragma unroll
      for (int mm = 0; mm + 1 < C; ++mm) {
#pragma unroll
        for (int j = 0; j < kTangentStreams; ++j) {
          w[mm][j] = w[mm + 1][j];
          if constexpr (D_INPUTS) dw[mm][j] = dw[mm + 1][j];
        }
      }
    }
  }
}

// One thread per column, the ragged last block masked; the budget of the
// C = 1 kernel of the same mode.
template <typename T, bool EVAP, bool LREGCL, bool D_INPUTS, int C>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, D_INPUTS>))
    cloudsc2_tl_chunk_kernel(const __grid_constant__ Args<T> a, const int ncol,
                             const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column_chunked<T, EVAP, LREGCL, D_INPUTS, C>(a, ncol, nlev, col);
}

template <typename T, bool D_INPUTS, int C>
int launch_chunk_levels(Args<T>& a, const double* params, int ncol, int nlev,
                        int evap, int lregcl, cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  if (evap) {
    if (lregcl) {
      fill_constants<T, true, true>(a, params);
      cloudsc2_tl_chunk_kernel<T, true, true, D_INPUTS, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
    } else {
      fill_constants<T, true, false>(a, params);
      cloudsc2_tl_chunk_kernel<T, true, false, D_INPUTS, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
    }
  } else if (lregcl) {
    fill_constants<T, false, true>(a, params);
    cloudsc2_tl_chunk_kernel<T, false, true, D_INPUTS, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    fill_constants<T, false, false>(a, params);
    cloudsc2_tl_chunk_kernel<T, false, false, D_INPUTS, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

// Fills Args from the launcher's pointer arrays (the primal streams always
// written; with D_INPUTS the checkpoints null) and launches `chunk` levels a
// step; returns a cudaError_t, cudaErrorInvalidValue for a chunk not built
// (2, 3 and 4 are).
template <typename T, bool D_INPUTS>
int launch_chunked(const void* const* in, const void* const* din,
                   void* const* out, const double* params, double dscale,
                   int ncol, int nlev, int evap, int lregcl, int chunk,
                   void* stream) {
  Args<T> a = {};
  const int err = fill_args<T, D_INPUTS>(a, in, din, out, dscale, ncol, nlev, 1);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 2:
      return launch_chunk_levels<T, D_INPUTS, 2>(a, params, ncol, nlev, evap, lregcl, s);
    case 3:
      return launch_chunk_levels<T, D_INPUTS, 3>(a, params, ncol, nlev, evap, lregcl, s);
    case 4:
      return launch_chunk_levels<T, D_INPUTS, 4>(a, params, ncol, nlev, evap, lregcl, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace cloudsc2_tl
