// CLOUDSC2 tangent-linear sweep over bfloat16-encoded level streams: the TPU
// kernel `_tl_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:170,
// decode :154-167) as `cloudsc2_pallas_tl_encoded`
// (cloudsc2jax/pallas/experiments.py:603) runs it on an encoding made with
// `payload_dtype=bfloat16` (:103, :146; `_EncGeometry` :515-536 asks only
// that pq, plu and paph be f32): the `dscale` mode with carry checkpoints,
// with and without the primal streams.
//
// cloudsc2_tl_enc.cu's kernel with the load policy
// cloudsc2_load::EncodedLevelsBf16T: a payload's float is its 16 bits
// shifted into the high half of an f32 (where the int16 policy converts),
// then the same decode float(q) * scale + offset, multiply and add rounded
// separately, so the results equal cloudsc2_tl.cu's on the decoded inputs
// bit for bit.  The same bytes move as with int16 payloads (13 16-bit + 3
// f32 streams read a level with the default encoding), at that kernel's
// budget of 7 blocks of 128 threads per SM (CLOUDSC2_TL_ENC_BF16_MIN_BLOCKS_F32),
// and the default encoding's mask has a kernel of its own.  Float only.  A
// library of its own, so that cloudsc2_tl_enc.cu keeps its code.

#include "cloudsc2_tl_sweep.cuh"

#ifndef CLOUDSC2_TL_ENC_BF16_MIN_BLOCKS_F32
#define CLOUDSC2_TL_ENC_BF16_MIN_BLOCKS_F32 7
#endif

namespace cloudsc2_tl {

template <bool EVAP, bool LREGCL, bool WRITE_PRIMAL, typename Load>
__global__ void __launch_bounds__(kThreads, CLOUDSC2_TL_ENC_BF16_MIN_BLOCKS_F32)
    cloudsc2_tl_enc_bf16_kernel(const __grid_constant__ Args<float> a,
                                const int ncol, const int nlev) {
  sweep<float, EVAP, LREGCL, WRITE_PRIMAL, false, Load>(a, ncol, nlev);
}

template <bool EVAP, bool LREGCL, typename Load>
int launch_bf16(const Args<float>& a, int ncol, int nlev, bool write_primal,
                cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  if (write_primal) {
    cloudsc2_tl_enc_bf16_kernel<EVAP, LREGCL, true, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_tl_enc_bf16_kernel<EVAP, LREGCL, false, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

// The default encoding's mask gets the kernel in which it is a constant.
template <bool EVAP, bool LREGCL>
int launch_bf16(Args<float>& a, const double* params, int ncol, int nlev,
                bool write_primal, cudaStream_t s) {
  using namespace cloudsc2_load;
  fill_constants<float, EVAP, LREGCL>(a, params);
  return a.enc_mask == kDefaultMask
             ? launch_bf16<EVAP, LREGCL, EncodedLevelsBf16T<kDefaultMask>>(
                   a, ncol, nlev, write_primal, s)
             : launch_bf16<EVAP, LREGCL, EncodedLevelsBf16T<>>(a, ncol, nlev,
                                                                write_primal, s);
}

}  // namespace cloudsc2_tl

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tl_enc_bf16_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::N_OUTPUT;
  counts[2] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_enc_bf16_param_names() { return cloudsc2_tl::kParamNames; }

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// As cloudsc2_tl_enc_f32, with in[j] pointing to (nlev, ncol) bfloat16
// payloads where bit j of `enc_mask` is set.
int cloudsc2_tl_enc_bf16_f32(const void* const* in, void* const* out,
                             const double* params, const void* levels,
                             unsigned enc_mask, double dscale, int ncol,
                             int nlev, int evap, int lregcl, int write_primal,
                             void* stream) {
  using namespace cloudsc2_tl;
  if (levels == nullptr || reinterpret_cast<uintptr_t>(levels) % 16 != 0) {
    return int(cudaErrorInvalidValue);
  }
  Args<float> a = {};
  const int err = fill_args<float, false>(a, in, nullptr, out, dscale, ncol, nlev,
                                          write_primal, levels, enc_mask);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wp = write_primal != 0;
  if (evap) {
    return lregcl ? launch_bf16<true, true>(a, params, ncol, nlev, wp, s)
                  : launch_bf16<true, false>(a, params, ncol, nlev, wp, s);
  }
  return lregcl ? launch_bf16<false, true>(a, params, ncol, nlev, wp, s)
                : launch_bf16<false, false>(a, params, ncol, nlev, wp, s);
}

}  // extern "C"
