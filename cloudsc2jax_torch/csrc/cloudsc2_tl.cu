// CLOUDSC2 tangent-linear sweep with in-register increments and carry
// checkpoints: the `dscale` mode of the TPU kernel `_tl_kernel`
// (cloudsc2jax/pallas/tlad_kernel.py:170), the TL half of the TL+AD work
// unit.  The kernel and its schedule are in cloudsc2_tl_sweep.cuh; this file
// instantiates `cloudsc2_tl_kernel` for float/double x evap x lregcl x
// write_primal and gives it a plain C interface, reports what each
// instance costs an SM (cloudsc2_occupancy.cuh), and holds its traced twin,
// `cloudsc2_tl_stamped_kernel`, which stamps each warp (cloudsc2_stamps.cuh).

#include "cloudsc2_occupancy.cuh"
#include "cloudsc2_stamps.cuh"
#include "cloudsc2_tl_sweep.cuh"

namespace {

using cloudsc2_tl::kThreads;

// Blocks of kThreads an SM the twin is held to: the shipped instance's
// budget in f32; in f64, where the shipped instance has none, the 3 blocks
// (12 warps, tlad.f64) it reaches without evaporation, which the twin left
// free did not (190 registers against 150: 2 blocks).  The spans take the
// twin's blocks from cloudsc2_tl_stamped_occupancy_f32/f64, not from here;
// tests/test_torch_stamps.py holds them to the shipped instance's on a card.
template <typename T, bool EVAP>
constexpr int kTwinBlocks = sizeof(T) == 4 ? cloudsc2_tl::kMinBlocks<T, false> : EVAP ? 1 : 3;

// `cloudsc2_tl_kernel`'s sweep at its blocks an SM, each warp stamped into
// `records`.
template <typename T, bool EVAP, bool LREGCL, bool WRITE_PRIMAL>
__global__ void __launch_bounds__(kThreads, (kTwinBlocks<T, EVAP>))
    cloudsc2_tl_stamped_kernel(const __grid_constant__ cloudsc2_tl::Args<T> a,
                               const int ncol, const int nlev,
                               cloudsc2_stamps::Record* const records) {
  cloudsc2_stamps::open<kThreads>(records);
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  cloudsc2_tl::sweep_column<T, EVAP, LREGCL, WRITE_PRIMAL, false, cloudsc2_load::Exact>(
      a, ncol, nlev, col, ncol, col);
  cloudsc2_stamps::close<kThreads>(records, col, ncol);
}

// The stamped twins of cloudsc2_tl::Shipped's kernels, which
// cloudsc2_tl::launch runs with the records after their own arguments.
struct Stamped {
  template <typename T, bool EVAP, bool LREGCL, bool WRITE_PRIMAL>
  static auto kernel() {
    return cloudsc2_tl_stamped_kernel<T, EVAP, LREGCL, WRITE_PRIMAL>;
  }
};

// The instance of `Kernels` that `launch_variant` runs for these switches,
// read at its launch configuration (no dynamic shared memory).
template <typename Kernels, typename T, bool EVAP, bool LREGCL>
int occupancy_of(const int write_primal, int* out) {
  return cloudsc2_occupancy::read(write_primal
                                      ? Kernels::template kernel<T, EVAP, LREGCL, true>()
                                      : Kernels::template kernel<T, EVAP, LREGCL, false>(),
                                  kThreads, 0, out);
}

template <typename T, typename Kernels = cloudsc2_tl::Shipped>
int occupancy(const int evap, const int lregcl, const int write_primal, int* out) {
  if (evap) {
    return lregcl ? occupancy_of<Kernels, T, true, true>(write_primal, out)
                  : occupancy_of<Kernels, T, true, false>(write_primal, out);
  }
  return lregcl ? occupancy_of<Kernels, T, false, true>(write_primal, out)
                : occupancy_of<Kernels, T, false, false>(write_primal, out);
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

// cloudsc2_tl_f32/f64 with each warp's record written to `records`, one
// cloudsc2_stamps::Record a warp of the grid (cloudsc2_stamps.cuh).
int cloudsc2_tl_stamped_f32(const void* const* in, void* const* out,
                            const double* params, double dscale, int ncol, int nlev,
                            int evap, int lregcl, int write_primal, void* records,
                            void* stream) {
  if (records == nullptr) return int(cudaErrorInvalidValue);
  return cloudsc2_tl::launch<float, false, Stamped>(
      in, nullptr, out, params, dscale, ncol, nlev, evap, lregcl, write_primal, stream,
      static_cast<cloudsc2_stamps::Record*>(records));
}

int cloudsc2_tl_stamped_f64(const void* const* in, void* const* out,
                            const double* params, double dscale, int ncol, int nlev,
                            int evap, int lregcl, int write_primal, void* records,
                            void* stream) {
  if (records == nullptr) return int(cudaErrorInvalidValue);
  return cloudsc2_tl::launch<double, false, Stamped>(
      in, nullptr, out, params, dscale, ncol, nlev, evap, lregcl, write_primal, stream,
      static_cast<cloudsc2_stamps::Record*>(records));
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

// The same of the stamped twins that cloudsc2_tl_stamped_f32/f64 launch.
int cloudsc2_tl_stamped_occupancy_f32(int evap, int lregcl, int write_primal, int* out) {
  return occupancy<float, Stamped>(evap, lregcl, write_primal, out);
}

int cloudsc2_tl_stamped_occupancy_f64(int evap, int lregcl, int write_primal, int* out) {
  return occupancy<double, Stamped>(evap, lregcl, write_primal, out);
}

}  // extern "C"
