// CLOUDSC2 reverse-adjoint sweep over int16-encoded level streams: the TPU
// kernel `_rev_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:454,
// decode :524) as `cloudsc2_pallas_ad_encoded`
// (cloudsc2jax/pallas/experiments.py:658) runs it, from the checkpoints the
// encoded TL sweep wrote.
//
// What it computes is cloudsc2_ad.cu's sweep on the DECODED trajectory (the
// same decode as cloudsc2_tl_enc.cu, so TL and AD are derivatives of one
// quantised primal and the adjoint identity holds to rounding).  The 3
// checkpoint and 8 seed streams are f32, produced on the device and never
// stored encoded; the 16 adjoints are f32.  The schedule, the in-place
// scatter of d_plu and d_paph and the seed fold are cloudsc2_ad_sweep.cuh's,
// unchanged; only the load differs (cloudsc2_load::EncodedLevels).  pq, plu
// and paph must be f32 streams; the launcher refuses a mask that says
// otherwise.  Float only.
//
// Traffic per level and column with the default encoding: 82 B read (13
// int16 + 3 f32 inputs, 3 checkpoints, 8 seeds) where the exact sweep reads
// 108, and 64 B written.  The exact sweep's time follows the issue of its
// level body, not its bytes, on this card (cloudsc2_ad_sweep.cuh), so the
// design keeps the policy's own work in the level loop small: the decode
// table is level-major, one 128 B line per level read as 7 float4 loads;
// the never-encoded streams compile to the exact loads; the default
// encoding's mask has a kernel of its own with one load per stream and no
// select (cloudsc2_load::EncodedLevelsT).  Its register budget is a define
// of its own, CLOUDSC2_AD_ENC_MIN_BLOCKS_F32 (blocks of 128 threads per SM;
// probes/tlad_budget.py `ad_enc`).
//
// A library of its own, so that the exact kernels of cloudsc2_ad.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_ad_sweep.cuh"

// the exact kernel's 5 blocks (95 registers, 20 warps per SM): the fastest of
// 4-6 on an NVIDIA H100 (probes/tlad_budget.py; PERF.md)
#ifndef CLOUDSC2_AD_ENC_MIN_BLOCKS_F32
#define CLOUDSC2_AD_ENC_MIN_BLOCKS_F32 CLOUDSC2_AD_MIN_BLOCKS_F32
#endif

namespace cloudsc2_ad {

// One thread per column, the ragged last block masked.
template <bool EVAP, bool LREGCL, typename Load>
__global__ void __launch_bounds__(kThreads, CLOUDSC2_AD_ENC_MIN_BLOCKS_F32)
    cloudsc2_ad_enc_kernel(const __grid_constant__ Args<float> a, const int ncol,
                           const int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];  // the body's slots
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<float, EVAP, LREGCL, Load, false>(
      a, ncol, nlev, col, ncol, col, stash_of<float, EVAP, LREGCL>(smem));
}

template <bool EVAP, bool LREGCL, typename Load>
int launch_encoded(const Args<float>& a, int ncol, int nlev, cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  constexpr size_t bytes = stash_bytes<float, EVAP, LREGCL>(kThreads);
  auto kernel = cloudsc2_ad_enc_kernel<EVAP, LREGCL, Load>;
  const int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, bytes, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

// The default encoding's mask gets the kernel in which it is a constant.
template <bool EVAP, bool LREGCL>
int launch_encoded(Args<float>& a, const double* params, int ncol, int nlev,
                   cudaStream_t s) {
  using namespace cloudsc2_load;
  fill_constants<float, EVAP, LREGCL>(a, params);
  return a.enc_mask == kDefaultMask
             ? launch_encoded<EVAP, LREGCL, EncodedLevelsT<kDefaultMask>>(
                   a, ncol, nlev, s)
             : launch_encoded<EVAP, LREGCL, EncodedLevels>(a, ncol, nlev, s);
}

}  // namespace cloudsc2_ad

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_enc_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_enc_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep on `stream` and returns the cudaError_t of the
// launch.  `in` holds N_STREAM device pointers, of which in[j], j < 16,
// points to (nlev, ncol) int16 payloads where bit j of `enc_mask` is set and
// to f32 values otherwise; `levels` is the level-major (nlev+1, 16, 2) f32
// [scale, offset] table on the device, 16 B aligned; `out` holds N_OUTPUT
// f32 pointers; `params` kNumParams host doubles.
int cloudsc2_ad_enc_f32(const void* const* in, void* const* out,
                        const double* params, const void* levels,
                        unsigned enc_mask, double seed_rfl, double seed_sfl,
                        int ncol, int nlev, int evap, int lregcl,
                        void* stream) {
  using namespace cloudsc2_ad;
  if (levels == nullptr || reinterpret_cast<uintptr_t>(levels) % 16 != 0) {
    return int(cudaErrorInvalidValue);
  }
  Args<float> a = {};
  const int err = fill_args<float>(a, in, out, seed_rfl, seed_sfl, ncol, nlev,
                                   levels, enc_mask);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_encoded<true, true>(a, params, ncol, nlev, s)
                  : launch_encoded<true, false>(a, params, ncol, nlev, s);
  }
  return lregcl ? launch_encoded<false, true>(a, params, ncol, nlev, s)
                : launch_encoded<false, false>(a, params, ncol, nlev, s);
}

}  // extern "C"
