// CLOUDSC2 tangent-linear sweep with streamed increments: the `d_inputs`
// mode of the TPU kernel `_tl_kernel` (cloudsc2jax/pallas/tlad_kernel.py:170;
// :196-199, 240-242, 348-361), the standalone TL that the Taylor-test
// variant checks.  The kernel and its schedule are in cloudsc2_tl_sweep.cuh;
// this file instantiates `cloudsc2_tl_din_kernel` for float/double x evap x
// lregcl and gives it a plain C interface.  It reads 16 input and 16 tangent
// streams and writes 8 primal and 8 tangent streams, and no checkpoints.

#include "cloudsc2_tl_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, tangent streams,
// outputs, params), so the caller can check that it was built against the
// same layout.
int cloudsc2_tl_din_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::kTangentStreams;
  counts[2] = cloudsc2_tl::N_OUTPUT;
  counts[3] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_din_param_names() { return cloudsc2_tl::kParamNames; }

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds N_STREAM device pointers, `din` kTangentStreams (the tangents of
// the first 16 streams, same shapes), `out` N_OUTPUT with the 3 checkpoint
// slots null, `params` kNumParams host doubles; every level array is (nlev,
// ncol), paph and d_paph (nlev+1, ncol).
int cloudsc2_tl_din_f32(const void* const* in, const void* const* din,
                        void* const* out, const double* params, int ncol,
                        int nlev, int evap, int lregcl, void* stream) {
  return cloudsc2_tl::launch<float, true>(in, din, out, params, 0.0, ncol,
                                          nlev, evap, lregcl, 1, stream);
}

int cloudsc2_tl_din_f64(const void* const* in, const void* const* din,
                        void* const* out, const double* params, int ncol,
                        int nlev, int evap, int lregcl, void* stream) {
  return cloudsc2_tl::launch<double, true>(in, din, out, params, 0.0, ncol,
                                           nlev, evap, lregcl, 1, stream);
}

}  // extern "C"
