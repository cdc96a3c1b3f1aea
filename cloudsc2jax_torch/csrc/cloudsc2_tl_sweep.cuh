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
// (cloudsc2_tlad_fused.cu) calls `sweep_column` for each column a thread
// owns and sends the checkpoints to a scratch indexed by the thread's slot
// instead of by the column (`ckpt_stride`, `ckpt_col`).
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

// Blocks of kThreads per SM the register budget must allow (f32), by mode;
// the f64 kernels are left unbounded.  A budget of 0 declares the block
// size alone, as the kernels first did: ptxas then gave the f32
// kernels 128 registers, where a minimum of 1 block lets it take 156-188.
template <typename T, bool D_INPUTS>
constexpr int kMinBlocks =
    sizeof(T) != 4 ? 1 : D_INPUTS ? CLOUDSC2_TL_DIN_MIN_BLOCKS_F32
                                  : CLOUDSC2_TL_MIN_BLOCKS_F32;
#if CLOUDSC2_TL_MIN_BLOCKS_F32 > 0
#define CLOUDSC2_TL_BOUNDS(T) __launch_bounds__(kThreads, (kMinBlocks<T, false>))
#else
#define CLOUDSC2_TL_BOUNDS(T) __launch_bounds__(kThreads)
#endif
#if CLOUDSC2_TL_DIN_MIN_BLOCKS_F32 > 0
#define CLOUDSC2_TL_DIN_BOUNDS(T) __launch_bounds__(kThreads, (kMinBlocks<T, true>))
#else
#define CLOUDSC2_TL_DIN_BOUNDS(T) __launch_bounds__(kThreads)
#endif

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
  // cloudsc2_load::Encoded only: the (16, table_rows, 2) [scale, offset]
  // table and the streams that hold int16 payloads, bit j for in[j]
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
__global__ void CLOUDSC2_TL_BOUNDS(T)
    cloudsc2_tl_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  sweep<T, EVAP, LREGCL, WRITE_PRIMAL, false, Load>(a, ncol, nlev);
}

template <typename T, bool EVAP, bool LREGCL>
__global__ void CLOUDSC2_TL_DIN_BOUNDS(T)
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

template <typename T, bool EVAP, bool LREGCL, bool D_INPUTS, typename Load>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   bool write_primal, cudaStream_t s) {
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

// Fills Args from the launcher's pointer arrays and picks the variant.
// `din` is read only with D_INPUTS, where the primal streams are always
// written and no checkpoint is.  `table` and `enc_mask` are read only with
// cloudsc2_load::Encoded.
template <typename T, bool D_INPUTS, typename Load = cloudsc2_load::Exact>
int launch(const void* const* in, const void* const* din, void* const* out,
           const double* params, double dscale, int ncol, int nlev, int evap,
           int lregcl, int write_primal, void* stream,
           const void* table = nullptr, unsigned enc_mask = 0u) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  if (D_INPUTS && !write_primal) return int(cudaErrorInvalidValue);
  Args<T> a = {};
  a.table = static_cast<const float2*>(table);
  a.table_rows = nlev + 1;
  a.enc_mask = enc_mask;
  if (enc_mask != 0u &&
      (table == nullptr || (enc_mask & cloudsc2_load::kNeverEncoded) ||
       enc_mask >> kTangentStreams)) {
    return int(cudaErrorInvalidValue);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wp = write_primal != 0;
  if (evap) {
    return lregcl ? launch_variant<T, true, true, D_INPUTS, Load>(a, params, ncol, nlev, wp, s)
                  : launch_variant<T, true, false, D_INPUTS, Load>(a, params, ncol, nlev, wp, s);
  }
  return lregcl ? launch_variant<T, false, true, D_INPUTS, Load>(a, params, ncol, nlev, wp, s)
                : launch_variant<T, false, false, D_INPUTS, Load>(a, params, ncol, nlev, wp, s);
}

}  // namespace cloudsc2_tl
