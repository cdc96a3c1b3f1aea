// CLOUDSC2 reverse-adjoint sweep from carry checkpoints, with the
// shifted-view adjoints scattered in place: one thread owns one column.
//
// Replaces the TPU kernel `_rev_kernel` (cloudsc2jax/pallas/tlad_kernel.py:454)
// in its in-place-scatter branch (:518-562), as `cloudsc2_pallas_ad` (:613)
// runs it: for the work unit with `checkpoints=..., fold_seeds=True`, and for
// the standalone adjoint after the checkpointing forward sweep
// (cloudsc2_fwd_ckpt_kernel in cloudsc2_nl.cu) with seed scales of 1.  The
// statements of one level, primal recompute and transpose, are generated
// from the port's level body by cloudsc2jax_torch/kernels/emit.py
// (`torch.func.vjp` of `level_physics`, once per setting of (levapls2 or
// ldrain1d, lregcl)) into cloudsc2_ad_level.cuh; this file is the
// hand-written schedule around them.
//
// Schedule.  The TPU grid ran the levels backwards with reversed index maps
// and one extra flush step, and carried the adjoint in VMEM scratch.  Here
// each thread runs k = nlev-1 ... 0 over its own column with the adjoint
// carry in registers.  Each level reads the raw fields, the 3 carry-in
// checkpoints a forward sweep wrote and the 8 seeds, scales the flux seeds
// (by (1 + rlvtt^2) and (1 + rlstt^2), folded in double on the host, when
// the seeds are the TL image; by 1 when the caller folded the 10-field
// cotangent itself), and runs the generated transpose.  The shifted views accumulate in
// the thread that owns the column: d_paph[k+1] = hi(k) + lo(k+1) with lo
// carried one step; d_plu[k+1] = the plu(k+1) cotangent of level k, and
// d_plu[0] = 0 (the clamped last-level read has a zero cotangent, as
// `llo1` is masked by not_last); the surface row adds the sum over levels
// of the paph_sfc cotangent at the end, so no pass over the result follows
// (the TPU path's `.at[nlev].add`, tlad_kernel.py:763).
//
// Traffic per level and column: 27 reads (16 input, 3 checkpoint, 8 seed
// streams) and 16 writes; each stream is read once and each result written
// once, with paph(k+1) carried from the step before.  What bounds the
// kernel on this card is not those bytes but the warps per SM its registers
// allow: the level body recomputes the level and transposes it, and printed
// in the traced order (all of the primal, then all of the transpose) it
// holds ~180 values at the turn, so the kernel compiled to 164-168
// registers (12 warps per SM) and ran at 29% of its bytes bound (PERF.md).
// Recomputing those values near their reads instead cost more issue slots
// than the warps it bought (PERF.md).  The emitter now prints the
// body with each primal statement sunk to its first read and the
// longest-lived values parked in shared memory (kernels/emit.py: 94 values
// live in registers for 184, 75 slots of 4 bytes per thread in f32, +16%
// statements), and the kernel asks for CLOUDSC2_AD_MIN_BLOCKS_F32 blocks of
// 128 threads per SM, chosen by probes/tlad_budget.py, which builds the
// kernel once per budget through that define.  Each thread's slots are a
// column of its own with a stride of kStashStride values (cloudsc2_math.cuh).
// Staging the next levels' 27 values in shared memory by `cp.async` while a
// level computes lost or tied at every budget, so the loads stay plain
// (PERF.md).
//
// Two more kernels run this schedule.  The int16-encoded sweep
// (cloudsc2_ad_enc.cu) differs only in how an input stream value is loaded:
// the `Load` policy of cloudsc2_load.cuh.  The single-launch TL+AD unit
// (cloudsc2_tlad_fused.cu) calls `sweep_column` in its AD warpgroups on a
// tile its TL warpgroup has swept, with PRODUCED_HERE: the checkpoints then
// come from a ring slot in a scratch (`ckpt_stride`, `ckpt_col`), and they
// and the seeds, both written by this very kernel, are read with plain
// loads, since the read-only path (`__ldg`) is undefined on data the
// running kernel wrote.  Its stash is indexed by the thread's place among
// the AD warpgroups (stash_at), not in the block.
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// fast math.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cloudsc2_ad_level.cuh"
#include "cloudsc2_load.cuh"

#ifndef CLOUDSC2_AD_MIN_BLOCKS_F32
#define CLOUDSC2_AD_MIN_BLOCKS_F32 5
#endif

namespace cloudsc2_ad {

constexpr int kThreads = 128;
constexpr int kFields = 14;  // level rows read at k; then plu, paph

// Blocks per SM the register budget must allow (f32).  The f64 body runs a
// benchmarked deployment (the cell tlad.f64) whose budget has not been
// chosen yet, so it is left unbounded.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? CLOUDSC2_AD_MIN_BLOCKS_F32 : 1;

// Pointer order of Args::in (AD_STREAMS in kernels/tlad_kernel.py).
enum Stream {
  S_PT, S_PQ, S_PQS, S_PAP, S_PL, S_PI, S_PLUDE, S_PMFU, S_PMFD,
  S_TEN_T, S_TEN_Q, S_TEN_L, S_TEN_I, S_PSUPSAT, S_PLU, S_PAPH,
  S_CETA, S_ZSCALM, S_ZTRPAUS, S_PAPH_SFC,
  S_CKPT,           // 3 carry-in checkpoints: rfl, sfl, covptot
  S_SEED = S_CKPT + 3,  // 8 seeds: tenl_t tenl_q tenl_l tenl_i pclc pcovptot rfln sfln
  N_STREAM = S_SEED + 8
};

// Pointer order of Args::out (AD_OUTPUTS): the 14 level-field adjoints,
// then d_plu (nlev rows) and d_paph (nlev+1 rows).
enum Output {
  O_D_PLU = kFields, O_D_PAPH,
  N_OUTPUT
};

template <typename T>
struct Args {
  const T* in[N_STREAM];
  T* out[N_OUTPUT];
  T seed_rfl, seed_sfl;
  T k[kMaxConsts];
  // cloudsc2_load::EncodedLevels only: the level-major (table_rows, 16, 2)
  // [scale, offset] table on the device and the streams that hold int16
  // payloads, bit j for in[j]
  const float2* table;
  int table_rows;
  unsigned enc_mask;
};

// A value this kernel may have written itself: never through `__ldg`.
template <bool PRODUCED_HERE, typename T>
__device__ __forceinline__ T load_produced(const T* p) {
  return PRODUCED_HERE ? *p : __ldg(p);
}

// The first slot of thread `t` of a level body's shared-memory slots that
// start at `base`: slot j lies kStashStride * j values after it
// (stash_bytes).
template <typename T, bool EVAP, bool LREGCL>
__device__ __forceinline__ T* stash_at(unsigned char* base, const int t) {
  return reinterpret_cast<T*>(base) +
         (t / kStashStride) * kStashStride * Level<EVAP, LREGCL>::kStashSlots +
         t % kStashStride;
}

// This thread's first slot, indexed by its place in the block.
template <typename T, bool EVAP, bool LREGCL>
__device__ __forceinline__ T* stash_of(unsigned char* base) {
  return stash_at<T, EVAP, LREGCL>(base, threadIdx.x);
}

// The reverse level loop of one column.  Checkpoint j of level k is read at
// in[S_CKPT + j][k * ckpt_stride + ckpt_col]: (ncol, col) for the checkpoint
// streams of the two-kernel unit.  `stash` is this thread's first slot of
// the level body's (stash_of).
template <typename T, bool EVAP, bool LREGCL, typename Load, bool PRODUCED_HERE>
__device__ __forceinline__ void sweep_column(const Args<T>& a, const int ncol,
                                             const int nlev, const int64_t col,
                                             const int64_t ckpt_stride,
                                             const int64_t ckpt_col,
                                             T* const stash) {
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  T sr[3] = {T(0.0), T(0.0), T(0.0)};  // adjoint of the carry out of level k
  T dlo = T(0.0);   // lo(k+1): the paph(k+1) cotangent of level k+1
  T dsfc = T(0.0);  // sum over levels of the paph_sfc cotangent
  T top = T(0.0);   // d_paph[nlev] before the surface sum
  T paph_hi = Load::template value<T>(
      a, S_PAPH, nlev,
      Load::template fetch<T>(a, S_PAPH, int64_t(nlev) * ncol + col));

  for (int k = nlev - 1; k >= 0; --k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
    const int64_t i1 = int64_t(k1) * ncol + col;
    T x[17];
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = Load::template fetch<T>(a, j, i);
    x[14] = Load::template fetch<T>(a, S_PLU, i1);
    x[15] = Load::template fetch<T>(a, S_PAPH, i);
    x[16] = paph_hi;
    T r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[j] = load_produced<PRODUCED_HERE>(a.in[S_CKPT + j] +
                                          int64_t(k) * ckpt_stride + ckpt_col);
    }
    T s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = load_produced<PRODUCED_HERE>(a.in[S_SEED + j] + i);
    }
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = Load::template value<T>(a, j, k, x[j]);
    x[14] = Load::template value<T>(a, S_PLU, k1, x[14]);
    x[15] = Load::template value<T>(a, S_PAPH, k, x[15]);
    s[6] = s[6] * a.seed_rfl;
    s[7] = s[7] * a.seed_sfl;

    T gx[17], gsfc, gr[3];
    Level<EVAP, LREGCL>::run(a.k, __ldg(a.in[S_CETA] + k),
                             __ldg(a.in[S_ZSCALM] + k), k < nlev - 1, x, c, r,
                             s, sr, gx, gsfc, gr, stash);
#pragma unroll
    for (int j = 0; j < kFields; ++j) a.out[j][i] = gx[j];
    if (k < nlev - 1) a.out[O_D_PLU][i + ncol] = gx[14];
    const T hi = gx[16] + dlo;
    if (k < nlev - 1) {
      a.out[O_D_PAPH][i + ncol] = hi;
    } else {
      top = hi;
    }
    dlo = gx[15];
    dsfc = dsfc + gsfc;
#pragma unroll
    for (int j = 0; j < 3; ++j) sr[j] = gr[j];
    paph_hi = x[15];
  }
  a.out[O_D_PLU][col] = T(0.0);
  a.out[O_D_PAPH][col] = dlo;
  a.out[O_D_PAPH][int64_t(nlev) * ncol + col] = top + dsfc;
}

// One thread per column, the ragged last block masked.
template <typename T, bool EVAP, bool LREGCL, typename Load>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    cloudsc2_ad_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];  // the body's slots
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<T, EVAP, LREGCL, Load, false>(a, ncol, nlev, col, ncol, col,
                                              stash_of<T, EVAP, LREGCL>(smem));
}

// Bytes of the level body's shared-memory slots for a block of `threads`:
// threads are grouped by kStashStride, each group owning kStashSlots rows.
template <typename T, bool EVAP, bool LREGCL>
constexpr size_t stash_bytes(const int threads) {
  return size_t((threads + kStashStride - 1) / kStashStride) * kStashStride *
         Level<EVAP, LREGCL>::kStashSlots * sizeof(T);
}

// Sets the dynamic shared memory `kernel` may use to `bytes`; returns the
// cudaError_t and clears it, so that the next launch does not inherit it.
template <typename Kernel>
inline int allow_shared(Kernel kernel, const size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return int(err);
}

// Folds the level body's constants in double and rounds them to T once.
template <typename T, bool EVAP, bool LREGCL>
void fill_constants(Args<T>& a, const double* params) {
  using L = Level<EVAP, LREGCL>;
  double k[kMaxConsts];
  L::constants(params, k);
  for (int j = 0; j < L::kNumConsts; ++j) a.k[j] = T(k[j]);
}

// The exact kernel of the switches: what `launch` runs unless it is handed
// another family of the same instances (cloudsc2_ad.cu's stamped twins),
// which take the arguments it passes on.
struct Shipped {
  template <typename T, bool EVAP, bool LREGCL>
  static auto kernel() {
    return cloudsc2_ad_kernel<T, EVAP, LREGCL, cloudsc2_load::Exact>;
  }
};

template <typename T, bool EVAP, bool LREGCL, typename Kernels, typename... Extra>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   cudaStream_t s, Extra... extra) {
  fill_constants<T, EVAP, LREGCL>(a, params);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  constexpr size_t bytes = stash_bytes<T, EVAP, LREGCL>(kThreads);
  auto kernel = Kernels::template kernel<T, EVAP, LREGCL>();
  const int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, bytes, s>>>(a, ncol, nlev, extra...);
  return int(cudaGetLastError());
}

static_assert((1u << S_PQ | 1u << S_PLU | 1u << S_PAPH) ==
                  cloudsc2_load::kNeverEncoded,
              "cloudsc2_load.cuh numbers the streams differently");

// Fills Args from the launcher's pointer arrays; returns a cudaError_t.
// `table` and `enc_mask` are the encoded kernel's
// (cloudsc2_load::EncodedLevels); the mask may set none of
// cloudsc2_load::kNeverEncoded.
template <typename T>
int fill_args(Args<T>& a, const void* const* in, void* const* out,
              double seed_rfl, double seed_sfl, int ncol, int nlev,
              const void* table = nullptr, unsigned enc_mask = 0u) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  if ((enc_mask & cloudsc2_load::kNeverEncoded) || enc_mask >> (S_PAPH + 1)) {
    return int(cudaErrorInvalidValue);
  }
  a.table = static_cast<const float2*>(table);
  a.table_rows = nlev + 1;
  a.enc_mask = enc_mask;
  for (int j = 0; j < N_STREAM; ++j) a.in[j] = static_cast<const T*>(in[j]);
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  a.seed_rfl = T(seed_rfl);
  a.seed_sfl = T(seed_sfl);
  return 0;
}

// Fills Args from the launcher's pointer arrays and picks the variant of
// the exact kernel, of `Kernels`, launched with `extra` after its own
// arguments.
template <typename T, typename Kernels = Shipped, typename... Extra>
int launch(const void* const* in, void* const* out, const double* params,
           double seed_rfl, double seed_sfl, int ncol, int nlev, int evap,
           int lregcl, void* stream, Extra... extra) {
  Args<T> a = {};
  const int err = fill_args<T>(a, in, out, seed_rfl, seed_sfl, ncol, nlev);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_variant<T, true, true, Kernels>(a, params, ncol, nlev, s, extra...)
                  : launch_variant<T, true, false, Kernels>(a, params, ncol, nlev, s, extra...);
  }
  return lregcl ? launch_variant<T, false, true, Kernels>(a, params, ncol, nlev, s, extra...)
                : launch_variant<T, false, false, Kernels>(a, params, ncol, nlev, s, extra...);
}

// ---------------------------------------------------------------------------
// The second store policy: the 17-stream adjoint convention.
//
// `_rev_kernel` without in-place scatter (tlad_kernel.py:564-610), as
// `cloudsc2_pallas_ad(inplace_scatter=False)` runs it (:765-803, the only
// convention its `chunk_levels > 1` takes): every level writes the
// cotangents of all 17 values it read, at the slot of its own physical level
// k: the 14 level rows, d_plu_k1 (the plu(k+1) read), d_paph_lo (paph(k))
// and d_paph_hi (paph(k+1)); the sum over levels of the paph_sfc cotangent
// leaves as one row of ncol values.  The caller assembles d_plu and d_paph
// from them in PyTorch (`assemble_shifted_adjoints` in
// kernels/tlad_kernel.py: two concatenations, an add, the surface row added
// last), so the kernel writes one (nlev, ncol) stream more than the in-place
// policy and leaves a pass over 3 more to the caller.  The sums are those
// of the in-place policy (hi(k) + lo(k+1) in either order, the surface row
// after), so the assembled adjoints are its results bit for bit.
//
// Outputs: Args::out[0..13] the level adjoints, out[O_D_PLU] d_plu_k1 and
// out[O_D_PAPH] d_paph_lo, each (nlev, ncol); the two below.
template <typename T>
struct ShiftedArgs : Args<T> {
  T* paph_hi;   // d_paph_hi, (nlev, ncol)
  T* paph_sfc;  // the surface row's sum, (ncol)
};

// Pointer order of the 17-stream launchers' `out` (AD_SHIFTED_OUTPUTS).
enum ShiftedOutput {
  O_D_PLU_K1 = O_D_PLU, O_D_PAPH_LO = O_D_PAPH, O_D_PAPH_HI, O_D_PAPH_SFC,
  N_SHIFTED_OUTPUT
};

// Values a level reads, in the order its loads are issued: the 14 level
// rows, plu(k+1), paph(k), the 3 checkpoints, the 8 seeds.
constexpr int kLevelReads = kFields + 2 + 3 + 8;

// The reverse loop of one column under the 17-stream policy, C levels a
// step.  A step first issues the 27 loads of each of its C levels, the
// counterpart of the TPU's C-level DMA window (`_chunk_reads`,
// tlad_kernel.py:105; the descending loop :567), then runs the C level
// bodies in descending order, each on the values at the head of the window,
// which moves down one level after each body.  The bodies are one loop of
// their own that is not unrolled, so the window costs registers (27 (C-1)
// values live across a body) and not a copy of the body per level.  Windows
// start at the top level; the last, partial one (137 is prime) loads and
// runs only the levels that exist, so nothing past them is read or written.
// paph(k+1) of level k is paph(k) of the level above, carried.  C = 1 is
// the 17-stream policy's own kernel (cloudsc2_ad_xscat.cu).
template <typename T, bool EVAP, bool LREGCL, int C>
__device__ __forceinline__ void sweep_column_shifted(const ShiftedArgs<T>& a,
                                                     const int ncol,
                                                     const int nlev,
                                                     const int64_t col,
                                                     T* const stash) {
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  T sr[3] = {T(0.0), T(0.0), T(0.0)};  // adjoint of the carry out of level k
  T dsfc = T(0.0);  // sum over levels of the paph_sfc cotangent
  T paph_hi = __ldg(a.in[S_PAPH] + int64_t(nlev) * ncol + col);

  for (int top = nlev - 1; top >= 0; top -= C) {
    const int n = top + 1 < C ? top + 1 : C;  // levels top ... top - n + 1
    T w[C][kLevelReads];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (m < n) {
        const int k = top - m;
        const int64_t i = int64_t(k) * ncol + col;
        const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
#pragma unroll
        for (int j = 0; j < kFields; ++j) w[m][j] = __ldg(a.in[j] + i);
        w[m][14] = __ldg(a.in[S_PLU] + int64_t(k1) * ncol + col);
        w[m][15] = __ldg(a.in[S_PAPH] + i);
#pragma unroll
        for (int j = 0; j < 3; ++j) w[m][16 + j] = __ldg(a.in[S_CKPT + j] + i);
#pragma unroll
        for (int j = 0; j < 8; ++j) w[m][19 + j] = __ldg(a.in[S_SEED + j] + i);
      }
    }
#pragma unroll 1
    for (int m = 0; m < n; ++m) {
      const int k = top - m;
      const int64_t i = int64_t(k) * ncol + col;
      T x[17];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = w[0][j];
      x[16] = paph_hi;
      T r[3], s[8];
#pragma unroll
      for (int j = 0; j < 3; ++j) r[j] = w[0][16 + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = w[0][19 + j];
      s[6] = s[6] * a.seed_rfl;
      s[7] = s[7] * a.seed_sfl;

      T gx[17], gsfc, gr[3];
      Level<EVAP, LREGCL>::run(a.k, __ldg(a.in[S_CETA] + k),
                               __ldg(a.in[S_ZSCALM] + k), k < nlev - 1, x, c, r,
                               s, sr, gx, gsfc, gr, stash);
#pragma unroll
      for (int j = 0; j < kFields; ++j) a.out[j][i] = gx[j];
      a.out[O_D_PLU_K1][i] = gx[14];
      a.out[O_D_PAPH_LO][i] = gx[15];
      a.paph_hi[i] = gx[16];
      dsfc = dsfc + gsfc;
#pragma unroll
      for (int j = 0; j < 3; ++j) sr[j] = gr[j];
      paph_hi = x[15];
#pragma unroll
      for (int mm = 0; mm + 1 < C; ++mm) {
#pragma unroll
        for (int j = 0; j < kLevelReads; ++j) w[mm][j] = w[mm + 1][j];
      }
    }
  }
  a.paph_sfc[col] = dsfc;
}

// One thread per column, the ragged last block masked; the budget of the
// in-place kernel.
template <typename T, bool EVAP, bool LREGCL, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    cloudsc2_ad_shifted_kernel(const __grid_constant__ ShiftedArgs<T> a,
                               const int ncol, const int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];  // the body's slots
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column_shifted<T, EVAP, LREGCL, C>(a, ncol, nlev, col,
                                           stash_of<T, EVAP, LREGCL>(smem));
}

template <typename T, bool EVAP, bool LREGCL, int C>
int launch_shifted_variant(ShiftedArgs<T>& a, const double* params, int ncol,
                           int nlev, cudaStream_t s) {
  fill_constants<T, EVAP, LREGCL>(a, params);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  constexpr size_t bytes = stash_bytes<T, EVAP, LREGCL>(kThreads);
  auto kernel = cloudsc2_ad_shifted_kernel<T, EVAP, LREGCL, C>;
  const int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, bytes, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

// Fills ShiftedArgs from the launcher's pointer arrays (`out` holds
// N_SHIFTED_OUTPUT pointers) and picks the variant; returns a cudaError_t.
template <typename T, int C>
int launch_shifted(const void* const* in, void* const* out,
                   const double* params, double seed_rfl, double seed_sfl,
                   int ncol, int nlev, int evap, int lregcl, void* stream) {
  ShiftedArgs<T> a = {};
  const int err = fill_args<T>(a, in, out, seed_rfl, seed_sfl, ncol, nlev);
  if (err != 0) return err;
  a.paph_hi = static_cast<T*>(out[O_D_PAPH_HI]);
  a.paph_sfc = static_cast<T*>(out[O_D_PAPH_SFC]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_shifted_variant<T, true, true, C>(a, params, ncol, nlev, s)
                  : launch_shifted_variant<T, true, false, C>(a, params, ncol, nlev, s);
  }
  return lregcl ? launch_shifted_variant<T, false, true, C>(a, params, ncol, nlev, s)
                : launch_shifted_variant<T, false, false, C>(a, params, ncol, nlev, s);
}

}  // namespace cloudsc2_ad
