// CLOUDSC2 reverse-adjoint sweep with C levels a step: the TPU kernel
// `_rev_kernel` (cloudsc2jax/pallas/tlad_kernel.py:454) with `chunk` > 1
// (the descending loop :567, the reads `_chunk_reads` :105), as
// `cloudsc2_pallas_ad(chunk_levels=C)` (:625) runs it, under the 17-stream
// convention, the only one JAX takes with chunks (:664-667).
//
// The sweep is `sweep_column_shifted<T, EVAP, LREGCL, C>` of
// cloudsc2_ad_sweep.cuh, which says how a step issues the loads of its C
// levels before it runs their bodies; its outputs are the 17-stream
// kernel's (cloudsc2_ad_xscat.cu), and its results equal that kernel's bit
// for bit, since every level runs the same body on the same values in the
// same order.  The register budget is the in-place kernel's (5 blocks of 128
// threads per SM), which the window's 27 (C-1) extra live values must share:
// ptxas reports what spills.  Instantiated for C = 2, 3, 4 (the JAX tests'
// 2 and 3, the JAX harness's example 4), float/double x evap x lregcl; any
// other C is refused.

#include "cloudsc2_ad_sweep.cuh"

namespace {

template <typename T>
int launch_chunk(const void* const* in, void* const* out, const double* params,
                 double seed_rfl, double seed_sfl, int ncol, int nlev, int evap,
                 int lregcl, int chunk, void* stream) {
  using cloudsc2_ad::launch_shifted;
  switch (chunk) {
    case 2:
      return launch_shifted<T, 2>(in, out, params, seed_rfl, seed_sfl, ncol,
                                  nlev, evap, lregcl, stream);
    case 3:
      return launch_shifted<T, 3>(in, out, params, seed_rfl, seed_sfl, ncol,
                                  nlev, evap, lregcl, stream);
    case 4:
      return launch_shifted<T, 4>(in, out, params, seed_rfl, seed_sfl, ncol,
                                  nlev, evap, lregcl, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_chunk_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_SHIFTED_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_chunk_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep with `chunk` levels a step on `stream` and
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a chunk
// not built).  Arrays as for cloudsc2_ad_xscat_f32.
int cloudsc2_ad_chunk_f32(const void* const* in, void* const* out,
                          const double* params, double seed_rfl,
                          double seed_sfl, int ncol, int nlev, int evap,
                          int lregcl, int chunk, void* stream) {
  return launch_chunk<float>(in, out, params, seed_rfl, seed_sfl, ncol, nlev,
                             evap, lregcl, chunk, stream);
}

int cloudsc2_ad_chunk_f64(const void* const* in, void* const* out,
                          const double* params, double seed_rfl,
                          double seed_sfl, int ncol, int nlev, int evap,
                          int lregcl, int chunk, void* stream) {
  return launch_chunk<double>(in, out, params, seed_rfl, seed_sfl, ncol, nlev,
                              evap, lregcl, chunk, stream);
}

}  // extern "C"
