// CLOUDSC2 tangent-linear sweep with in-register increments and carry
// checkpoints: the `dscale` mode of the TPU kernel `_tl_kernel`
// (cloudsc2jax/pallas/tlad_kernel.py:170), the TL half of the TL+AD work
// unit.  The kernel and its schedule are in cloudsc2_tl_sweep.cuh; this file
// instantiates `cloudsc2_tl_kernel` for float/double x evap x lregcl x
// write_primal and gives it a plain C interface, and reports what each
// instance costs an SM (cloudsc2_occupancy.cuh).

#include "cloudsc2_occupancy.cuh"
#include "cloudsc2_tl_sweep.cuh"

namespace {

// The instance `launch_variant` runs for these switches, read at its launch
// configuration (no dynamic shared memory).
template <typename T, bool EVAP, bool LREGCL>
int occupancy_of(const int write_primal, int* out) {
  using cloudsc2_load::Exact;
  using cloudsc2_tl::cloudsc2_tl_kernel;
  using cloudsc2_tl::kThreads;
  return write_primal
             ? cloudsc2_occupancy::read(cloudsc2_tl_kernel<T, EVAP, LREGCL, true, Exact>,
                                        kThreads, 0, out)
             : cloudsc2_occupancy::read(cloudsc2_tl_kernel<T, EVAP, LREGCL, false, Exact>,
                                        kThreads, 0, out);
}

template <typename T>
int occupancy(const int evap, const int lregcl, const int write_primal, int* out) {
  if (evap) {
    return lregcl ? occupancy_of<T, true, true>(write_primal, out)
                  : occupancy_of<T, true, false>(write_primal, out);
  }
  return lregcl ? occupancy_of<T, false, true>(write_primal, out)
                : occupancy_of<T, false, false>(write_primal, out);
}

}  // namespace

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

// Writes registers and local bytes per thread, dynamic shared bytes per
// block and blocks per SM (cloudsc2_occupancy::Counter) of the instance that
// cloudsc2_tl_f32/f64 launch for these switches; returns a cudaError_t.
int cloudsc2_tl_occupancy_f32(int evap, int lregcl, int write_primal, int* out) {
  return occupancy<float>(evap, lregcl, write_primal, out);
}

int cloudsc2_tl_occupancy_f64(int evap, int lregcl, int write_primal, int* out) {
  return occupancy<double>(evap, lregcl, write_primal, out);
}

}  // extern "C"
