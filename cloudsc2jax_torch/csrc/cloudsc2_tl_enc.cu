// CLOUDSC2 tangent-linear sweep over int16-encoded level streams: the TPU
// kernel `_tl_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:170,
// decode :154-167 and :224) as `cloudsc2_pallas_tl_encoded`
// (cloudsc2jax/pallas/experiments.py:603) runs it: the `dscale` mode with
// carry checkpoints, with and without the primal streams.
//
// What it computes is cloudsc2_tl.cu's sweep on the DECODED trajectory:
// each value of an encoded stream is float(int16) * scale[level][stream] +
// offset[level][stream], and the increments dscale*x are formed from the
// decoded values, so the tangents are the exact tangents of the quantised
// primal.  The schedule is cloudsc2_tl_sweep.cuh's, unchanged; only the load
// differs (cloudsc2_load::EncodedLevels in cloudsc2_load.cuh, which also
// says why the decode is not one FMA).  pq, plu and paph must be f32
// streams, as in `_EncGeometry` (experiments.py:519-530); the launcher
// refuses a mask that says otherwise.  Float only.
//
// Traffic per level and column with the default encoding (13 int16 + 3 f32
// streams): 38 B read where the exact sweep reads 64, the writes unchanged
// (8 tangent, 3 checkpoint and optionally 8 primal f32 streams).  What
// bounds it on this card is what bounds the exact sweep, the issue of its
// level body (cloudsc2_tl_sweep.cuh), so the design keeps the policy's own
// work in the level loop small: the decode table is level-major, one 128 B
// line per level read as 7 float4 loads; the never-encoded streams compile
// to the exact loads; the default encoding's mask has a kernel of its own
// with one load per stream and no select (cloudsc2_load::EncodedLevelsT).
// Its register budget is a define of its own, CLOUDSC2_TL_ENC_MIN_BLOCKS_F32
// (blocks of 128 threads per SM; probes/tlad_budget.py `tl_enc`).
//
// A library of its own, so that the exact kernels of cloudsc2_tl.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_tl_sweep.cuh"

// 7 blocks (72 registers, 28 warps per SM): the fastest of 6-9 on an NVIDIA
// H100, 4% ahead of the exact kernel's 8 (probes/tlad_budget.py; PERF.md)
#ifndef CLOUDSC2_TL_ENC_MIN_BLOCKS_F32
#define CLOUDSC2_TL_ENC_MIN_BLOCKS_F32 7
#endif

namespace cloudsc2_tl {

template <bool EVAP, bool LREGCL, bool WRITE_PRIMAL, typename Load>
__global__ void __launch_bounds__(kThreads, CLOUDSC2_TL_ENC_MIN_BLOCKS_F32)
    cloudsc2_tl_enc_kernel(const __grid_constant__ Args<float> a, const int ncol,
                           const int nlev) {
  sweep<float, EVAP, LREGCL, WRITE_PRIMAL, false, Load>(a, ncol, nlev);
}

template <bool EVAP, bool LREGCL, typename Load>
int launch_encoded(const Args<float>& a, int ncol, int nlev, bool write_primal,
                   cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  if (write_primal) {
    cloudsc2_tl_enc_kernel<EVAP, LREGCL, true, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_tl_enc_kernel<EVAP, LREGCL, false, Load><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

// The default encoding's mask gets the kernel in which it is a constant.
template <bool EVAP, bool LREGCL>
int launch_encoded(Args<float>& a, const double* params, int ncol, int nlev,
                   bool write_primal, cudaStream_t s) {
  using namespace cloudsc2_load;
  fill_constants<float, EVAP, LREGCL>(a, params);
  return a.enc_mask == kDefaultMask
             ? launch_encoded<EVAP, LREGCL, EncodedLevelsT<kDefaultMask>>(
                   a, ncol, nlev, write_primal, s)
             : launch_encoded<EVAP, LREGCL, EncodedLevels>(a, ncol, nlev,
                                                           write_primal, s);
}

}  // namespace cloudsc2_tl

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tl_enc_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::N_OUTPUT;
  counts[2] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_enc_param_names() { return cloudsc2_tl::kParamNames; }

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds N_STREAM device pointers, of which in[j] points to (nlev, ncol)
// int16 payloads where bit j of `enc_mask` is set and to f32 values
// otherwise; `levels` is the level-major (nlev+1, 16, 2) f32 [scale, offset]
// table on the device, 16 B aligned; `out` holds N_OUTPUT f32 pointers (the
// 8 primal ones may be null when write_primal is 0); `params` kNumParams
// host doubles.
int cloudsc2_tl_enc_f32(const void* const* in, void* const* out,
                        const double* params, const void* levels,
                        unsigned enc_mask, double dscale, int ncol, int nlev,
                        int evap, int lregcl, int write_primal, void* stream) {
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
    return lregcl ? launch_encoded<true, true>(a, params, ncol, nlev, wp, s)
                  : launch_encoded<true, false>(a, params, ncol, nlev, wp, s);
  }
  return lregcl ? launch_encoded<false, true>(a, params, ncol, nlev, wp, s)
                : launch_encoded<false, false>(a, params, ncol, nlev, wp, s);
}

}  // extern "C"
