// CLOUDSC2 tangent-linear sweep with in-register increments, carry
// checkpoints and C levels a step: the `dscale` mode of the TPU kernel
// `_tl_kernel` (cloudsc2jax/pallas/tlad_kernel.py:170) with `chunk` > 1
// (loop :220), as `cloudsc2_pallas_tl(..., dscale=..., save_checkpoints=True,
// chunk_levels=C)` (:284) runs it; the primal streams are always written
// (:321).
//
// The sweep is `sweep_column_chunked<T, EVAP, LREGCL, false, C>` of
// cloudsc2_tl_sweep.cuh, which says how a step issues the loads of its C
// levels before it runs their bodies; its results equal cloudsc2_tl.cu's
// with write_primal bit for bit.  Per level and column it moves what that
// kernel moves (16 reads; 8 tangent, 3 checkpoint and 8 primal writes) at
// that kernel's register budget (8 blocks of 128 threads per SM), which the
// window's 16 (C-1) extra live values must share: ptxas reports what
// spills.  Instantiated for C = 2, 3, 4, float/double x evap x lregcl; any
// other C is refused.  A library of its own, so that cloudsc2_tl.cu keeps
// its code and the nvcc runs overlap.

#include "cloudsc2_tl_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tl_chunk_abi(int* counts) {
  counts[0] = cloudsc2_tl::N_STREAM;
  counts[1] = cloudsc2_tl::N_OUTPUT;
  counts[2] = cloudsc2_tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tl_chunk_param_names() { return cloudsc2_tl::kParamNames; }

// Launches the sweep with `chunk` levels a step on `stream` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a chunk not built).
// `in` holds N_STREAM device pointers, `out` N_OUTPUT (none null), `params`
// kNumParams host doubles; every level array is (nlev, ncol) and paph
// (nlev+1, ncol).
int cloudsc2_tl_chunk_f32(const void* const* in, void* const* out,
                          const double* params, double dscale, int ncol,
                          int nlev, int evap, int lregcl, int chunk,
                          void* stream) {
  return cloudsc2_tl::launch_chunked<float, false>(
      in, nullptr, out, params, dscale, ncol, nlev, evap, lregcl, chunk, stream);
}

int cloudsc2_tl_chunk_f64(const void* const* in, void* const* out,
                          const double* params, double dscale, int ncol,
                          int nlev, int evap, int lregcl, int chunk,
                          void* stream) {
  return cloudsc2_tl::launch_chunked<double, false>(
      in, nullptr, out, params, dscale, ncol, nlev, evap, lregcl, chunk, stream);
}

}  // extern "C"
