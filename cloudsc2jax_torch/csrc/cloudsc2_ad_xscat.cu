// CLOUDSC2 reverse-adjoint sweep under the 17-stream adjoint convention:
// the TPU kernel `_rev_kernel` (cloudsc2jax/pallas/tlad_kernel.py:454) in
// its non-in-place branch (:564-610), as `cloudsc2_pallas_ad(...,
// inplace_scatter=False)` (:626, :662-667, assembly :765-803) runs it for
// the `xscat` and `xscatnp` schedules of the JAX harness (tools/kernel_ab.py).
//
// The sweep is `sweep_column_shifted` of cloudsc2_ad_sweep.cuh at one level
// a step: the in-place kernel's loads, level body and register budget (5
// blocks of 128 threads per SM, CLOUDSC2_AD_MIN_BLOCKS_F32), with every
// level storing the cotangents of its 17 reads at its own slot instead of
// adding the shifted ones in the thread.  Per level and column it reads
// what the in-place kernel reads (27 values) and writes 17 values where
// that one writes 16, and the caller assembles d_plu and d_paph in PyTorch;
// the assembled adjoints are the in-place kernel's bit for bit.  This file
// instantiates it for float/double x evap x lregcl and gives it a plain C
// interface; a library of its own, so that cloudsc2_ad.cu keeps its code.

#include "cloudsc2_ad_sweep.cuh"

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_ad_xscat_abi(int* counts) {
  counts[0] = cloudsc2_ad::N_STREAM;
  counts[1] = cloudsc2_ad::N_SHIFTED_OUTPUT;
  counts[2] = cloudsc2_ad::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_ad_xscat_param_names() { return cloudsc2_ad::kParamNames; }

// Launches the reverse sweep on `stream` and returns the cudaError_t of the
// launch.  `in` holds N_STREAM device pointers, `out` N_SHIFTED_OUTPUT (the
// 14 level adjoints, d_plu_k1, d_paph_lo and d_paph_hi, each (nlev, ncol),
// then the surface row, (ncol)), `params` kNumParams host doubles.
int cloudsc2_ad_xscat_f32(const void* const* in, void* const* out,
                          const double* params, double seed_rfl,
                          double seed_sfl, int ncol, int nlev, int evap,
                          int lregcl, void* stream) {
  return cloudsc2_ad::launch_shifted<float, 1>(in, out, params, seed_rfl,
                                               seed_sfl, ncol, nlev, evap,
                                               lregcl, stream);
}

int cloudsc2_ad_xscat_f64(const void* const* in, void* const* out,
                          const double* params, double seed_rfl,
                          double seed_sfl, int ncol, int nlev, int evap,
                          int lregcl, void* stream) {
  return cloudsc2_ad::launch_shifted<double, 1>(in, out, params, seed_rfl,
                                                seed_sfl, ncol, nlev, evap,
                                                lregcl, stream);
}

}  // extern "C"
