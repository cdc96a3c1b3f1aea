// CLOUDSC2 reverse-adjoint sweep over int16-encoded level streams: the TPU
// kernel `_rev_kernel(encoded=True)` (cloudsc2jax/pallas/tlad_kernel.py:454,
// decode :524) as `cloudsc2_pallas_ad_encoded`
// (cloudsc2jax/pallas/experiments.py:658) runs it, from the checkpoints the
// encoded TL sweep wrote.
//
// What it computes is cloudsc2_ad.cu's sweep on the DECODED trajectory (the
// same decode as cloudsc2_tl_enc.cu, so TL and AD are derivatives of one
// quantised primal and the adjoint identity holds to rounding).  The 3
// checkpoint and 8 seed streams are f32, produced on the device and never
// stored encoded; the 16 adjoints are f32.  The schedule, the in-place
// scatter of d_plu and d_paph and the seed fold are cloudsc2_ad_sweep.cuh's,
// unchanged; only the load differs (cloudsc2_load::Encoded).  pq, plu and
// paph must be f32 streams; the launcher refuses a mask that says otherwise.
// Float only.
//
// Traffic per level and column with the default encoding: 82 B read (13
// int16 + 3 f32 inputs, 3 checkpoints, 8 seeds) where the exact sweep reads
// 108, and 64 B written.  The exact sweep's time follows its warps per SM
// and not its bytes on this card (PERF.md), so the diet is measured, not
// assumed.
//
// A library of its own, so that the exact kernels of cloudsc2_ad.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_ad_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_enc_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_enc_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep on `stream` and returns the cudaError_t of the
// launch.  `in` holds N_STREAM device pointers, of which in[j], j < 16,
// points to (nlev, ncol) int16 payloads where bit j of `enc_mask` is set and
// to f32 values otherwise; `table` is the (16, nlev+1, 2) f32 [scale,
// offset] table on the device; `out` holds N_OUTPUT f32 pointers; `params`
// kNumParams host doubles.
int cloudsc2_ad_enc_f32(const void* const* in, void* const* out,
                        const double* params, const void* table,
                        unsigned enc_mask, double seed_rfl, double seed_sfl,
                        int ncol, int nlev, int evap, int lregcl,
                        void* stream) {
  if (table == nullptr) return int(cudaErrorInvalidValue);
  return cloudsc2_ad::launch<float, cloudsc2_load::Encoded>(
      in, out, params, seed_rfl, seed_sfl, ncol, nlev, evap, lregcl, stream,
      table, enc_mask);
}

}  // extern "C"
