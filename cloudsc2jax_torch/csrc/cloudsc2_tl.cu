// CLOUDSC2 tangent-linear sweep with in-register increments and carry
// checkpoints: one thread owns one column.
//
// Replaces the TPU kernel `_tl_kernel` (cloudsc2jax/pallas/tlad_kernel.py:170)
// as the work unit runs it, through `cloudsc2_pallas_tl(dscale=0.01,
// save_checkpoints=True, write_primal=...)` (:272).  The statements of one
// level, primal and tangent, are generated from the port's level body by
// cloudsc2jax_torch/kernels/emit.py (`torch.func.jvp` of `level_physics`
// with lregcl=True) into cloudsc2_tl_level.cuh; this file is the hand-written
// schedule around them.
//
// Schedule.  The TPU grid ran (column block, level) in order and carried
// the primal and tangent carries in VMEM scratch.  Here each thread loops
// over the levels of its own column with rfl/sfl/covptot and their tangents
// in registers.  Arrays are levels-major (nlev, ncol) without padding, so a
// warp's read of one level is one coalesced row segment; the ragged last
// block masks its tail.  paph(k+1) of level k is kept as paph(k) of level
// k+1, and plu is read only at k+1 (clamped at the last level, as
// `_level_index_maps` does), so each of the 16 input streams (pqs included)
// is read once per level.  The increments are never streamed: dx = dscale*x
// is formed in registers for the 17 level values and paph_sfc, and the
// tropopause eta has a zero tangent (tlad_kernel.py:238-245).
//
// Traffic per level and column: 16 reads; 8 tangent, 3 checkpoint and,
// with WRITE_PRIMAL, 8 primal writes.  The level body is ~1,000
// statements, about 3x the NL body, for 35-43 values moved, so on this
// card it is still bound by device-memory bytes unless register spills
// move the bound; the design moves each byte once and keeps everything
// else in registers.
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// fast math.  Params arrive as host doubles; the constants Python would fold
// in double are folded on the host by Level<EVAP>::constants and rounded to
// T once.

#include <cuda_runtime.h>

#include <cstdint>

#include "cloudsc2_tl_level.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFields = 14;  // level rows read at k; then plu, paph

// Pointer order of Args::in (TL_STREAMS in kernels/tlad_kernel.py).
enum Stream {
  S_PT, S_PQ, S_PQS, S_PAP, S_PL, S_PI, S_PLUDE, S_PMFU, S_PMFD,
  S_TEN_T, S_TEN_Q, S_TEN_L, S_TEN_I, S_PSUPSAT, S_PLU, S_PAPH,
  S_CETA, S_ZSCALM, S_ZTRPAUS, S_PAPH_SFC,
  N_STREAM
};

// Pointer order of Args::out (TL_OUTPUTS): 8 tangents, 3 carry-in
// checkpoints, 8 primal outputs (null unless WRITE_PRIMAL).
enum Output {
  O_TANGENT = 0, O_CKPT = 8, O_PRIMAL = 11,
  N_OUTPUT = 19
};

template <typename T>
struct Args {
  const T* in[N_STREAM];
  T* out[N_OUTPUT];
  T dscale;
  T k[cloudsc2_tl::kMaxConsts];
};

template <typename T, bool EVAP, bool WRITE_PRIMAL>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_tl_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const T dscale = a.dscale;
  const T c[2] = {__ldg(a.in[S_ZTRPAUS] + col), __ldg(a.in[S_PAPH_SFC] + col)};
  const T dpaph_sfc = dscale * c[1];
  T r[3] = {T(0.0), T(0.0), T(0.0)};
  T dr[3] = {T(0.0), T(0.0), T(0.0)};
  T paph_lo = __ldg(a.in[S_PAPH] + col);

  for (int k = 0; k < nlev; ++k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int64_t i1 = int64_t(k + 1 < nlev ? k + 1 : nlev - 1) * ncol + col;
    T x[17];
#pragma unroll
    for (int j = 0; j < kFields; ++j) x[j] = __ldg(a.in[j] + i);
    x[14] = __ldg(a.in[S_PLU] + i1);
    x[15] = paph_lo;
    x[16] = __ldg(a.in[S_PAPH] + int64_t(k + 1) * ncol + col);
    T dx[17];
#pragma unroll
    for (int j = 0; j < 17; ++j) dx[j] = dscale * x[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) a.out[O_CKPT + j][i] = r[j];

    T y[8], ry[3], dy[8], dry[3];
    cloudsc2_tl::Level<EVAP>::run(a.k, __ldg(a.in[S_CETA] + k),
                                  __ldg(a.in[S_ZSCALM] + k), k < nlev - 1, x,
                                  c, r, dx, dpaph_sfc, dr, y, ry, dy, dry);
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
  }
}

template <typename T, bool EVAP, bool WRITE_PRIMAL>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   cudaStream_t s) {
  double k[cloudsc2_tl::kMaxConsts];
  cloudsc2_tl::Level<EVAP>::constants(params, k);
  for (int j = 0; j < cloudsc2_tl::Level<EVAP>::kNumConsts; ++j) a.k[j] = T(k[j]);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  cloudsc2_tl_kernel<T, EVAP, WRITE_PRIMAL><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const double* params,
           double dscale, int ncol, int nlev, int evap, int write_primal,
           void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  Args<T> a = {};
  for (int j = 0; j < N_STREAM; ++j) a.in[j] = static_cast<const T*>(in[j]);
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  if (write_primal) {
    for (int j = O_PRIMAL; j < N_OUTPUT; ++j)
      if (a.out[j] == nullptr) return int(cudaErrorInvalidValue);
  }
  a.dscale = T(dscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return write_primal ? launch_variant<T, true, true>(a, params, ncol, nlev, s)
                        : launch_variant<T, true, false>(a, params, ncol, nlev, s);
  }
  return write_primal ? launch_variant<T, false, true>(a, params, ncol, nlev, s)
                      : launch_variant<T, false, false>(a, params, ncol, nlev, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tl_abi(int* counts) {
  counts[0] = N_STREAM;
  counts[1] = N_OUTPUT;
  counts[2] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_param_names() { return cloudsc2_tl::kParamNames; }

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds N_STREAM device pointers, `out` N_OUTPUT (the 8 primal ones may
// be null when write_primal is 0), `params` kNumParams host doubles; every
// level array is (nlev, ncol) and paph (nlev+1, ncol).
int cloudsc2_tl_f32(const void* const* in, void* const* out,
                    const double* params, double dscale, int ncol, int nlev,
                    int evap, int write_primal, void* stream) {
  return launch<float>(in, out, params, dscale, ncol, nlev, evap,
                       write_primal, stream);
}

int cloudsc2_tl_f64(const void* const* in, void* const* out,
                    const double* params, double dscale, int ncol, int nlev,
                    int evap, int write_primal, void* stream) {
  return launch<double>(in, out, params, dscale, ncol, nlev, evap,
                        write_primal, stream);
}

}  // extern "C"
