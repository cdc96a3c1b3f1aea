// CLOUDSC2 reverse-adjoint sweep over bfloat16-encoded level streams: the
// TPU kernel `_rev_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:454,
// decode :524) as `cloudsc2_pallas_ad_encoded`
// (cloudsc2jax/pallas/experiments.py:658) runs it on an encoding made with
// `payload_dtype=bfloat16` (:103, :146), from the checkpoints the encoded TL
// sweep wrote.
//
// cloudsc2_ad_enc.cu's kernel with the load policy
// cloudsc2_load::EncodedLevelsBf16T (the shift decode, cloudsc2_load.cuh),
// the in-place scatter of d_plu and d_paph and the seed fold of
// cloudsc2_ad_sweep.cuh, so the adjoints equal cloudsc2_ad.cu's on the
// decoded inputs bit for bit.  The bytes of the int16 kernel (82 B read and
// 64 B written per level and column with the default encoding), at its
// budget of 5 blocks of 128 threads per SM (CLOUDSC2_AD_ENC_BF16_MIN_BLOCKS_F32);
// the default encoding's mask has a kernel of its own.  Float only.  A
// library of its own, so that cloudsc2_ad_enc.cu keeps its code.

#include "cloudsc2_ad_sweep.cuh"

#ifndef CLOUDSC2_AD_ENC_BF16_MIN_BLOCKS_F32
#define CLOUDSC2_AD_ENC_BF16_MIN_BLOCKS_F32 CLOUDSC2_AD_MIN_BLOCKS_F32
#endif

namespace cloudsc2_ad {

// One thread per column, the ragged last block masked.
template <bool EVAP, bool LREGCL, typename Load>
__global__ void __launch_bounds__(kThreads, CLOUDSC2_AD_ENC_BF16_MIN_BLOCKS_F32)
    cloudsc2_ad_enc_bf16_kernel(const __grid_constant__ Args<float> a,
                                const int ncol, const int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];  // the body's slots
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<float, EVAP, LREGCL, Load, false>(
      a, ncol, nlev, col, ncol, col, stash_of<float, EVAP, LREGCL>(smem));
}

template <bool EVAP, bool LREGCL, typename Load>
int launch_bf16(const Args<float>& a, int ncol, int nlev, cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  constexpr size_t bytes = stash_bytes<float, EVAP, LREGCL>(kThreads);
  auto kernel = cloudsc2_ad_enc_bf16_kernel<EVAP, LREGCL, Load>;
  const int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, bytes, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

// The default encoding's mask gets the kernel in which it is a constant.
template <bool EVAP, bool LREGCL>
int launch_bf16(Args<float>& a, const double* params, int ncol, int nlev,
                cudaStream_t s) {
  using namespace cloudsc2_load;
  fill_constants<float, EVAP, LREGCL>(a, params);
  return a.enc_mask == kDefaultMask
             ? launch_bf16<EVAP, LREGCL, EncodedLevelsBf16T<kDefaultMask>>(
                   a, ncol, nlev, s)
             : launch_bf16<EVAP, LREGCL, EncodedLevelsBf16T<>>(a, ncol, nlev, s);
}

}  // namespace cloudsc2_ad

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_enc_bf16_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_enc_bf16_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep on `stream` and returns the cudaError_t of the
// launch.  As cloudsc2_ad_enc_f32, with in[j], j < 16, pointing to (nlev,
// ncol) bfloat16 payloads where bit j of `enc_mask` is set.
int cloudsc2_ad_enc_bf16_f32(const void* const* in, void* const* out,
                             const double* params, const void* levels,
                             unsigned enc_mask, double seed_rfl,
                             double seed_sfl, int ncol, int nlev, int evap,
                             int lregcl, void* stream) {
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
    return lregcl ? launch_bf16<true, true>(a, params, ncol, nlev, s)
                  : launch_bf16<true, false>(a, params, ncol, nlev, s);
  }
  return lregcl ? launch_bf16<false, true>(a, params, ncol, nlev, s)
                : launch_bf16<false, false>(a, params, ncol, nlev, s);
}

}  // extern "C"
