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
// streams) and 16 writes.  The level body recomputes the level and then
// transposes it, ~1,000 statements with most intermediates live at the
// turn, so register pressure and spills are the first thing to read in
// ptxas' report; bytes are the bound the design works to: each stream is
// read once and each result written once, with paph(k+1) carried from the
// step before.
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// fast math.

#include <cuda_runtime.h>

#include <cstdint>

#include "cloudsc2_ad_level.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFields = 14;  // level rows read at k; then plu, paph

// Blocks per SM the register budget must allow.  Unbounded, ptxas gives
// the f32 body ~176 registers, which fits 2 blocks (8 warps) per SM; a
// bound of 3 caps it at 168 registers and 12 warps.  The f64 body needs
// 255 registers and spills either way, so it is left unbounded.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 1;

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
  T k[cloudsc2_ad::kMaxConsts];
};

template <typename T, bool EVAP, bool LREGCL>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    cloudsc2_ad_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  T sr[3] = {T(0.0), T(0.0), T(0.0)};  // adjoint of the carry out of level k
  T dlo = T(0.0);   // lo(k+1): the paph(k+1) cotangent of level k+1
  T dsfc = T(0.0);  // sum over levels of the paph_sfc cotangent
  T top = T(0.0);   // d_paph[nlev] before the surface sum
  T paph_hi = __ldg(a.in[S_PAPH] + int64_t(nlev) * ncol + col);

  for (int k = nlev - 1; k >= 0; --k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int64_t i1 = int64_t(k + 1 < nlev ? k + 1 : nlev - 1) * ncol + col;
    T x[17];
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = __ldg(a.in[j] + i);
    x[14] = __ldg(a.in[S_PLU] + i1);
    x[15] = __ldg(a.in[S_PAPH] + i);
    x[16] = paph_hi;
    T r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) r[j] = __ldg(a.in[S_CKPT + j] + i);
    T s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = __ldg(a.in[S_SEED + j] + i);
    s[6] = s[6] * a.seed_rfl;
    s[7] = s[7] * a.seed_sfl;

    T gx[17], gsfc, gr[3];
    cloudsc2_ad::Level<EVAP, LREGCL>::run(a.k, __ldg(a.in[S_CETA] + k),
                                          __ldg(a.in[S_ZSCALM] + k),
                                          k < nlev - 1, x, c, r, s, sr, gx,
                                          gsfc, gr);
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

template <typename T, bool EVAP, bool LREGCL>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   cudaStream_t s) {
  using L = cloudsc2_ad::Level<EVAP, LREGCL>;
  double k[cloudsc2_ad::kMaxConsts];
  L::constants(params, k);
  for (int j = 0; j < L::kNumConsts; ++j) a.k[j] = T(k[j]);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  cloudsc2_ad_kernel<T, EVAP, LREGCL><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const double* params,
           double seed_rfl, double seed_sfl, int ncol, int nlev, int evap,
           int lregcl, void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  Args<T> a = {};
  for (int j = 0; j < N_STREAM; ++j) a.in[j] = static_cast<const T*>(in[j]);
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  a.seed_rfl = T(seed_rfl);
  a.seed_sfl = T(seed_sfl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_variant<T, true, true>(a, params, ncol, nlev, s)
                  : launch_variant<T, true, false>(a, params, ncol, nlev, s);
  }
  return lregcl ? launch_variant<T, false, true>(a, params, ncol, nlev, s)
                : launch_variant<T, false, false>(a, params, ncol, nlev, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_abi(int* counts) {
  counts[0] = N_STREAM;
  counts[1] = N_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep on `stream` and returns the cudaError_t of the
// launch.  `in` holds N_STREAM device pointers, `out` N_OUTPUT, `params`
// kNumParams host doubles; every level array is (nlev, ncol), paph and
// d_paph (nlev+1, ncol).
int cloudsc2_ad_f32(const void* const* in, void* const* out,
                    const double* params, double seed_rfl, double seed_sfl,
                    int ncol, int nlev, int evap, int lregcl, void* stream) {
  return launch<float>(in, out, params, seed_rfl, seed_sfl, ncol, nlev, evap,
                       lregcl, stream);
}

int cloudsc2_ad_f64(const void* const* in, void* const* out,
                    const double* params, double seed_rfl, double seed_sfl,
                    int ncol, int nlev, int evap, int lregcl, void* stream) {
  return launch<double>(in, out, params, seed_rfl, seed_sfl, ncol, nlev, evap,
                        lregcl, stream);
}

}  // extern "C"
