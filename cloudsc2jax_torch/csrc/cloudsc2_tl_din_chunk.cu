// CLOUDSC2 tangent-linear sweep with streamed increments and C levels a
// step: the `d_inputs` mode of the TPU kernel `_tl_kernel`
// (cloudsc2jax/pallas/tlad_kernel.py:170; :196-199, 240-242, 348-361) with
// `chunk` > 1 (loop :220, `_chunk_reads` of the tangents :235-236), as
// `cloudsc2_pallas_tl(inputs, d_inputs, ..., chunk_levels=C)` (:284) runs
// it for the standalone TL.
//
// The sweep is `sweep_column_chunked<T, EVAP, LREGCL, true, C>` of
// cloudsc2_tl_sweep.cuh; its results equal cloudsc2_tl_din.cu's bit for bit,
// and like that library it is built without FMA contraction
// (SHIPPED_FLAGS of kernels/build.py), which the bit-for-bit equality needs.
// Per level and column it reads 32 values and writes 16, at that kernel's
// register budget (7 blocks of 128 threads per SM), which the window's 32
// (C-1) extra live values must share.  Instantiated for C = 2, 3, 4,
// float/double x evap x lregcl; any other C is refused.

#include "cloudsc2_tl_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, tangent streams,
// outputs, params), so the caller can check that it was built against the
// same layout.
int cloudsc2_tl_din_chunk_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::kTangentStreams;
  counts[2] = cloudsc2_tl::N_OUTPUT;
  counts[3] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_din_chunk_param_names() {
  return cloudsc2_tl::kParamNames;
}

// Launches the sweep with `chunk` levels a step on `stream` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a chunk not built).
// Arrays as for cloudsc2_tl_din_f32: `out` holds N_OUTPUT with the 3
// checkpoint slots null.
int cloudsc2_tl_din_chunk_f32(const void* const* in, const void* const* din,
                              void* const* out, const double* params, int ncol,
                              int nlev, int evap, int lregcl, int chunk,
                              void* stream) {
  return cloudsc2_tl::launch_chunked<float, true>(
      in, din, out, params, 0.0, ncol, nlev, evap, lregcl, chunk, stream);
}

int cloudsc2_tl_din_chunk_f64(const void* const* in, const void* const* din,
                              void* const* out, const double* params, int ncol,
                              int nlev, int evap, int lregcl, int chunk,
                              void* stream) {
  return cloudsc2_tl::launch_chunked<double, true>(
      in, din, out, params, 0.0, ncol, nlev, evap, lregcl, chunk, stream);
}

}  // extern "C"
