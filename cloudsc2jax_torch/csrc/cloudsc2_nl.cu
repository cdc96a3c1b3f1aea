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
// (cloudsc2_occupancy.cuh).

#include "cloudsc2_nl_sweep.cuh"
#include "cloudsc2_occupancy.cuh"

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

// The instance of the NL sweep `launch_variant` runs for `evap`, read at its
// launch configuration (no dynamic shared memory).
template <typename T>
int nl_occupancy(const int evap, int* out) {
  return evap ? cloudsc2_occupancy::read(cloudsc2_nl_kernel<T, true>, kThreads, 0, out)
              : cloudsc2_occupancy::read(cloudsc2_nl_kernel<T, false>, kThreads, 0, out);
}

template <typename T, bool EVAP, bool FWD_CKPT>
int launch_variant(const Args<T>& a, int ncol, int nlev, cudaStream_t s) {
  const unsigned blocks = blocks_for(ncol, kThreads);
  if (FWD_CKPT) {
    cloudsc2_fwd_ckpt_kernel<T, EVAP><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_nl_kernel<T, EVAP><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

template <typename T, bool FWD_CKPT>
int launch(const void* const* in, void* const* out, const double* consts,
           int ncol, int nlev, int evap, void* stream) {
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
  return evap ? launch_variant<T, true, FWD_CKPT>(a, ncol, nlev, s)
              : launch_variant<T, false, FWD_CKPT>(a, ncol, nlev, s);
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

// Writes registers and local bytes per thread, dynamic shared bytes per
// block and blocks per SM (cloudsc2_occupancy::Counter) of the instance that
// cloudsc2_nl_f32/f64 launch for `evap`; returns a cudaError_t.
int cloudsc2_nl_occupancy_f32(int evap, int* out) { return nl_occupancy<float>(evap, out); }

int cloudsc2_nl_occupancy_f64(int evap, int* out) { return nl_occupancy<double>(evap, out); }

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
