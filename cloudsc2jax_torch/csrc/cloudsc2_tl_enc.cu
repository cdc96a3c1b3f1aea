// CLOUDSC2 tangent-linear sweep over int16-encoded level streams: the TPU
// kernel `_tl_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:170,
// decode :154-167 and :224) as `cloudsc2_pallas_tl_encoded`
// (cloudsc2jax/pallas/experiments.py:603) runs it: the `dscale` mode with
// carry checkpoints, with and without the primal streams.
//
// What it computes is cloudsc2_tl.cu's sweep on the DECODED trajectory:
// each value of an encoded stream is float(int16) * scale[stream][level] +
// offset[stream][level], and the increments dscale*x are formed from the
// decoded values, so the tangents are the exact tangents of the quantised
// primal.  The schedule is cloudsc2_tl_sweep.cuh's, unchanged; only the load
// differs (cloudsc2_load::Encoded in cloudsc2_load.cuh, which also says why
// the decode is not one FMA).  pq, plu and paph must be f32 streams, as in
// `_EncGeometry` (experiments.py:519-530); the launcher refuses a mask that
// says otherwise.  Float only.
//
// Traffic per level and column with the default encoding (13 int16 + 3 f32
// streams): 38 B read where the exact sweep reads 64, the writes unchanged
// (8 tangent, 3 checkpoint and optionally 8 primal f32 streams).  The exact
// sweep is not bound by its bytes on this card (cloudsc2_tl_sweep.cuh), so
// the diet is measured, not assumed: PERF.md holds the times.
//
// A library of its own, so that the exact kernels of cloudsc2_tl.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_tl_sweep.cuh"

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
// otherwise; `table` is the (16, nlev+1, 2) f32 [scale, offset] table on the
// device; `out` holds N_OUTPUT f32 pointers (the 8 primal ones may be null
// when write_primal is 0); `params` kNumParams host doubles.
int cloudsc2_tl_enc_f32(const void* const* in, void* const* out,
                        const double* params, const void* table,
                        unsigned enc_mask, double dscale, int ncol, int nlev,
                        int evap, int lregcl, int write_primal, void* stream) {
  if (table == nullptr) return int(cudaErrorInvalidValue);
  return cloudsc2_tl::launch<float, false, cloudsc2_load::Encoded>(
      in, nullptr, out, params, dscale, ncol, nlev, evap, lregcl, write_primal,
      stream, table, enc_mask);
}

}  // extern "C"
