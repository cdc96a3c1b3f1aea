// CLOUDSC2 reverse-adjoint sweep from carry checkpoints: the TPU kernel
// `_rev_kernel` (cloudsc2jax/pallas/tlad_kernel.py:454) in its
// in-place-scatter branch, the AD half of the TL+AD work unit and of the
// standalone adjoint.  The kernel and its schedule are in
// cloudsc2_ad_sweep.cuh; this file instantiates `cloudsc2_ad_kernel` for
// float/double x evap x lregcl and gives it a plain C interface.

#include "cloudsc2_ad_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_OUTPUT;
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
  return cloudsc2_ad::launch<float>(in, out, params, seed_rfl, seed_sfl, ncol,
                                    nlev, evap, lregcl, stream);
}

int cloudsc2_ad_f64(const void* const* in, void* const* out,
                    const double* params, double seed_rfl, double seed_sfl,
                    int ncol, int nlev, int evap, int lregcl, void* stream) {
  return cloudsc2_ad::launch<double>(in, out, params, seed_rfl, seed_sfl, ncol,
                                     nlev, evap, lregcl, stream);
}

}  // extern "C"
