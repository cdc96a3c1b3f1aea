// CLOUDSC2 tangent-linear sweep with in-register increments and carry
// checkpoints: the `dscale` mode of the TPU kernel `_tl_kernel`
// (cloudsc2jax/pallas/tlad_kernel.py:170), the TL half of the TL+AD work
// unit.  The kernel and its schedule are in cloudsc2_tl_sweep.cuh; this file
// instantiates `cloudsc2_tl_kernel` for float/double x evap x lregcl x
// write_primal and gives it a plain C interface.

#include "cloudsc2_tl_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tl_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::N_OUTPUT;
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
                    int evap, int lregcl, int write_primal, void* stream) {
  return cloudsc2_tl::launch<float, false>(in, nullptr, out, params, dscale,
                                           ncol, nlev, evap, lregcl,
                                           write_primal, stream);
}

int cloudsc2_tl_f64(const void* const* in, void* const* out,
                    const double* params, double dscale, int ncol, int nlev,
                    int evap, int lregcl, int write_primal, void* stream) {
  return cloudsc2_tl::launch<double, false>(in, nullptr, out, params, dscale,
                                            ncol, nlev, evap, lregcl,
                                            write_primal, stream);
}

}  // extern "C"
