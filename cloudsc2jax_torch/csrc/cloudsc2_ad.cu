// CLOUDSC2 reverse-adjoint sweep from carry checkpoints: the TPU kernel
// `_rev_kernel` (cloudsc2jax/pallas/tlad_kernel.py:454) in its
// in-place-scatter branch, the AD half of the TL+AD work unit and of the
// standalone adjoint.  The kernel and its schedule are in
// cloudsc2_ad_sweep.cuh; this file instantiates `cloudsc2_ad_kernel` for
// float/double x evap x lregcl and gives it a plain C interface, and
// reports what each instance costs an SM (cloudsc2_occupancy.cuh).

#include "cloudsc2_ad_sweep.cuh"
#include "cloudsc2_occupancy.cuh"

namespace {

// The instance `launch_variant` runs for these switches, read at its launch
// configuration: the level body's shared-memory slots, allowed as the launch
// allows them.
template <typename T, bool EVAP, bool LREGCL>
int occupancy_of(int* out) {
  using namespace cloudsc2_ad;
  constexpr size_t bytes = stash_bytes<T, EVAP, LREGCL>(kThreads);
  auto kernel = cloudsc2_ad_kernel<T, EVAP, LREGCL, cloudsc2_load::Exact>;
  const int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  return cloudsc2_occupancy::read(kernel, kThreads, bytes, out);
}

template <typename T>
int occupancy(const int evap, const int lregcl, int* out) {
  if (evap) {
    return lregcl ? occupancy_of<T, true, true>(out) : occupancy_of<T, true, false>(out);
  }
  return lregcl ? occupancy_of<T, false, true>(out) : occupancy_of<T, false, false>(out);
}

}  // namespace

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

// Writes registers and local bytes per thread, dynamic shared bytes per
// block and blocks per SM (cloudsc2_occupancy::Counter) of the instance that
// cloudsc2_ad_f32/f64 launch for these switches; returns a cudaError_t.
int cloudsc2_ad_occupancy_f32(int evap, int lregcl, int* out) {
  return occupancy<float>(evap, lregcl, out);
}

int cloudsc2_ad_occupancy_f64(int evap, int lregcl, int* out) {
  return occupancy<double>(evap, lregcl, out);
}

}  // extern "C"
