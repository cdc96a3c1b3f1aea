// CLOUDSC2 checkpointing forward sweep with C levels a step: the TPU kernel
// `_fwd_ckpt_kernel` (cloudsc2jax/pallas/tlad_kernel.py:405) with `chunk` > 1
// (loop :427), the forward sweep of `cloudsc2_pallas_ad(chunk_levels=C)`
// (:694-711).
//
// The sweep is `fwd_ckpt_column_chunked<T, EVAP, C>` of
// cloudsc2_nl_sweep.cuh; its outputs and carry-in checkpoints equal
// `cloudsc2_fwd_ckpt_kernel`'s (cloudsc2_nl.cu) bit for bit.  Per level and
// column it reads 16 values and writes 11, as that kernel does; it is bound
// by those bytes, and the window lets each thread have 16 C loads in flight
// where that kernel has 16.  Instantiated for C = 2, 3, 4, float/double x
// evap; any other C is refused.  A library of its own, so that
// cloudsc2_nl.cu keeps its code.

#include "cloudsc2_nl_sweep.cuh"

namespace {

using namespace cloudsc2_nl;

// The launcher's `in` follows FWD_CKPT_STREAMS of
// cloudsc2jax_torch/kernels/cloudsc2_kernel.py: the NL streams, then pqs.
constexpr int kNlStreams = Order<false>::N;
constexpr int kFwdStreams = kNlStreams + 1;
constexpr int kFwdOutputs = N_OUTPUT + 3;

template <typename T, int C>
int launch_levels(const Args<T>& a, int ncol, int nlev, int evap,
                  cudaStream_t s) {
  const unsigned blocks = blocks_for(ncol, kThreads);
  if (evap) {
    cloudsc2_fwd_chunk_kernel<T, true, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_fwd_chunk_kernel<T, false, C><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const double* consts,
           int ncol, int nlev, int evap, int chunk, void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  using O = Order<true>;
  Args<T> a = {};
  // stream j of the pqs-less order sits one further once pqs has its place
  for (int j = 0; j < kNlStreams; ++j) {
    a.in[j >= O::PQS ? j + 1 : j] = static_cast<const T*>(in[j]);
  }
  a.in[O::PQS] = static_cast<const T*>(in[kNlStreams]);
  fill_outputs(a, out, consts);
  for (int j = 0; j < 3; ++j) a.ckpt[j] = static_cast<T*>(out[N_OUTPUT + j]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 2:
      return launch_levels<T, 2>(a, ncol, nlev, evap, s);
    case 3:
      return launch_levels<T, 3>(a, ncol, nlev, evap, s);
    case 4:
      return launch_levels<T, 4>(a, ncol, nlev, evap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, constants),
// so the caller can check that it was built against the same layout.
int cloudsc2_fwd_chunk_abi(int* counts) {
  counts[0] = kFwdStreams;
  counts[1] = kFwdOutputs;
  counts[2] = N_CONST;
  return 0;
}

// Launches the sweep with `chunk` levels a step on `stream` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a chunk not built).
// Arrays as for cloudsc2_fwd_ckpt_f32: `in` holds kFwdStreams device
// pointers (the NL streams, then pqs), `out` kFwdOutputs (the 8 outputs,
// then the 3 carry-in checkpoints, each (nlev, ncol)), `consts` N_CONST
// host doubles.
int cloudsc2_fwd_chunk_f32(const void* const* in, void* const* out,
                           const double* consts, int ncol, int nlev, int evap,
                           int chunk, void* stream) {
  return launch<float>(in, out, consts, ncol, nlev, evap, chunk, stream);
}

int cloudsc2_fwd_chunk_f64(const void* const* in, void* const* out,
                           const double* consts, int ncol, int nlev, int evap,
                           int chunk, void* stream) {
  return launch<double>(in, out, consts, ncol, nlev, evap, chunk, stream);
}

}  // extern "C"
