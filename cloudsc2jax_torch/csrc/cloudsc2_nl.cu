// CLOUDSC2 nonlinear sweep and checkpointing forward sweep: the two exact
// kernels over the schedule and hand-written level body of
// cloudsc2_nl_sweep.cuh, which says what they compute, which TPU kernels
// they replace (`_stream_kernel` with fuse_satur=True,
// cloudsc2jax/pallas/cloudsc2_kernel.py:348; `_fwd_ckpt_kernel`,
// cloudsc2jax/pallas/tlad_kernel.py:405) and what bounds them.
//
// `cloudsc2_nl_kernel` computes pqs in registers and writes no checkpoint;
// `cloudsc2_fwd_ckpt_kernel` reads pqs as a 16th stream and writes the 3
// carry-in checkpoints.  Both load with cloudsc2_load::Exact.  The file
// also reports what each instance of the NL sweep costs an SM
// (cloudsc2_occupancy.cuh), and holds the traced twin of the NL sweep,
// `cloudsc2_nl_stamped_kernel`, which stamps each warp (cloudsc2_stamps.cuh).

#include "cloudsc2_nl_sweep.cuh"
#include "cloudsc2_occupancy.cuh"
#include "cloudsc2_stamps.cuh"

namespace {

using namespace cloudsc2_nl;
using cloudsc2_load::Exact;

// The launchers' `in` arrays follow KERNEL_STREAMS and FWD_CKPT_STREAMS of
// cloudsc2jax_torch/kernels/cloudsc2_kernel.py: the streams without pqs and,
// for the checkpointing sweep, pqs after them.
constexpr int kNlStreams = Order<false>::N;
constexpr int kFwdStreams = kNlStreams + 1;
constexpr int kFwdOutputs = N_OUTPUT + 3;

template <typename T, bool EVAP>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_nl_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  sweep<T, EVAP, false, false, Exact>(a, ncol, nlev);
}

template <typename T, bool EVAP>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_fwd_ckpt_kernel(const __grid_constant__ Args<T> a, const int ncol,
                             const int nlev) {
  sweep<T, EVAP, true, true, Exact>(a, ncol, nlev);
}

// `cloudsc2_nl_kernel`'s sweep, each warp stamped into `records`.
template <typename T, bool EVAP>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_nl_stamped_kernel(const __grid_constant__ Args<T> a, const int ncol,
                               const int nlev, cloudsc2_stamps::Record* const records) {
  cloudsc2_stamps::open<kThreads>(records);
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<T, EVAP, false, false, Exact>(a, ncol, nlev, col);
  cloudsc2_stamps::close<kThreads>(records, col, ncol);
}

// The NL sweep's kernel of `evap`: what `launch` runs unless it is handed
// the stamped twins, which take the arguments it passes on.
struct Shipped {
  template <typename T, bool EVAP>
  static auto kernel() { return cloudsc2_nl_kernel<T, EVAP>; }
};

struct Stamped {
  template <typename T, bool EVAP>
  static auto kernel() { return cloudsc2_nl_stamped_kernel<T, EVAP>; }
};

// The instance of the NL sweep of `Kernels` that `launch_variant` runs for
// `evap`, read at its launch configuration (no dynamic shared memory).
template <typename T, typename Kernels = Shipped>
int nl_occupancy(const int evap, int* out) {
  return cloudsc2_occupancy::read(evap ? Kernels::template kernel<T, true>()
                                       : Kernels::template kernel<T, false>(),
                                  kThreads, 0, out);
}

template <typename T, bool EVAP, bool FWD_CKPT, typename Kernels, typename... Extra>
int launch_variant(const Args<T>& a, int ncol, int nlev, cudaStream_t s, Extra... extra) {
  const unsigned blocks = blocks_for(ncol, kThreads);
  if constexpr (FWD_CKPT) {
    cloudsc2_fwd_ckpt_kernel<T, EVAP><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    auto kernel = Kernels::template kernel<T, EVAP>();
    kernel<<<blocks, kThreads, 0, s>>>(a, ncol, nlev, extra...);
  }
  return int(cudaGetLastError());
}

// Fills Args from the launcher's arrays and launches the NL sweep of
// `Kernels` with `extra` after its own arguments, or with FWD_CKPT the
// checkpointing sweep.
template <typename T, bool FWD_CKPT, typename Kernels = Shipped, typename... Extra>
int launch(const void* const* in, void* const* out, const double* consts,
           int ncol, int nlev, int evap, void* stream, Extra... extra) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  using O = Order<FWD_CKPT>;
  Args<T> a = {};
  // stream j of the pqs-less order sits one further once pqs has its place
  for (int j = 0; j < kNlStreams; ++j) {
    a.in[FWD_CKPT && j >= O::PQS ? j + 1 : j] = static_cast<const T*>(in[j]);
  }
  fill_outputs(a, out, consts);
  if (FWD_CKPT) {
    a.in[O::PQS] = static_cast<const T*>(in[kNlStreams]);
    for (int j = 0; j < 3; ++j) a.ckpt[j] = static_cast<T*>(out[N_OUTPUT + j]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return evap ? launch_variant<T, true, FWD_CKPT, Kernels>(a, ncol, nlev, s, extra...)
              : launch_variant<T, false, FWD_CKPT, Kernels>(a, ncol, nlev, s, extra...);
}

}  // namespace

extern "C" {

// Writes the lengths of the three argument arrays, so the caller can check
// that it was built against the same layout.
int cloudsc2_nl_abi(int* counts) {
  counts[0] = kNlStreams;
  counts[1] = N_OUTPUT;
  counts[2] = N_CONST;
  return 0;
}

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds kNlStreams device pointers, `out` N_OUTPUT, `consts` N_CONST
// host doubles; every level array is (nlev, ncol) and paph (nlev+1, ncol).
int cloudsc2_nl_f32(const void* const* in, void* const* out,
                    const double* consts, int ncol, int nlev, int evap,
                    void* stream) {
  return launch<float, false>(in, out, consts, ncol, nlev, evap, stream);
}

int cloudsc2_nl_f64(const void* const* in, void* const* out,
                    const double* consts, int ncol, int nlev, int evap,
                    void* stream) {
  return launch<double, false>(in, out, consts, ncol, nlev, evap, stream);
}

// cloudsc2_nl_f32/f64 with each warp's record written to `records`, one
// cloudsc2_stamps::Record a warp of the grid (cloudsc2_stamps.cuh).
int cloudsc2_nl_stamped_f32(const void* const* in, void* const* out,
                            const double* consts, int ncol, int nlev, int evap,
                            void* records, void* stream) {
  if (records == nullptr) return int(cudaErrorInvalidValue);
  return launch<float, false, Stamped>(in, out, consts, ncol, nlev, evap, stream,
                                       static_cast<cloudsc2_stamps::Record*>(records));
}

int cloudsc2_nl_stamped_f64(const void* const* in, void* const* out,
                            const double* consts, int ncol, int nlev, int evap,
                            void* records, void* stream) {
  if (records == nullptr) return int(cudaErrorInvalidValue);
  return launch<double, false, Stamped>(in, out, consts, ncol, nlev, evap, stream,
                                        static_cast<cloudsc2_stamps::Record*>(records));
}

// Writes registers and local bytes per thread, dynamic shared bytes per
// block and blocks per SM (cloudsc2_occupancy::Counter) of the instance that
// cloudsc2_nl_f32/f64 launch for `evap`; returns a cudaError_t.
int cloudsc2_nl_occupancy_f32(int evap, int* out) { return nl_occupancy<float>(evap, out); }

int cloudsc2_nl_occupancy_f64(int evap, int* out) { return nl_occupancy<double>(evap, out); }

// The same of the stamped twins that cloudsc2_nl_stamped_f32/f64 launch.
int cloudsc2_nl_stamped_occupancy_f32(int evap, int* out) {
  return nl_occupancy<float, Stamped>(evap, out);
}

int cloudsc2_nl_stamped_occupancy_f64(int evap, int* out) {
  return nl_occupancy<double, Stamped>(evap, out);
}

// The lengths of the checkpointing sweep's argument arrays.
int cloudsc2_fwd_ckpt_abi(int* counts) {
  counts[0] = kFwdStreams;
  counts[1] = kFwdOutputs;
  counts[2] = N_CONST;
  return 0;
}

// Launches the checkpointing forward sweep on `stream` and returns the
// cudaError_t of the launch.  `in` holds kFwdStreams device pointers (the
// NL streams, then pqs), `out` kFwdOutputs (the 8 outputs, then the 3
// carry-in checkpoints, each (nlev, ncol)), `consts` N_CONST host doubles.
int cloudsc2_fwd_ckpt_f32(const void* const* in, void* const* out,
                          const double* consts, int ncol, int nlev, int evap,
                          void* stream) {
  return launch<float, true>(in, out, consts, ncol, nlev, evap, stream);
}

int cloudsc2_fwd_ckpt_f64(const void* const* in, void* const* out,
                          const double* consts, int ncol, int nlev, int evap,
                          void* stream) {
  return launch<double, true>(in, out, consts, ncol, nlev, evap, stream);
}

}  // extern "C"
