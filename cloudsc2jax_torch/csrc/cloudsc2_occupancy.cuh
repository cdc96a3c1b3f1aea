// What a kernel instance costs an SM, as the runtime reports it: registers
// and local memory per thread from cudaFuncGetAttributes, and the blocks an
// SM holds at the launch's own block size and dynamic shared memory from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.  The NL, TL and AD
// libraries export one entry per precision that reads the instance a launch
// with the same switches runs (cloudsc2_nl.cu, cloudsc2_tl.cu,
// cloudsc2_ad.cu); the wrappers read each instance once and hand the numbers
// to the sweeps' spans (`occupancy` in kernels/build.py).  Host code only:
// no kernel's code changes.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace cloudsc2_occupancy {

// Pointer order of the entries' `out` (OCCUPANCY in kernels/build.py).
enum Counter { C_REGISTERS, C_LOCAL_BYTES, C_SHARED_BYTES, C_BLOCKS_PER_SM, N_COUNTER };

// Fills `out` (N_COUNTER ints) for `kernel` launched with blocks of
// `threads` and `shared_bytes` of dynamic shared memory, which the caller
// has allowed it as its launch does; returns the cudaError_t, cleared.
template <typename Kernel>
int read(Kernel kernel, const int threads, const size_t shared_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        shared_bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  out[C_REGISTERS] = attr.numRegs;
  out[C_LOCAL_BYTES] = int(attr.localSizeBytes);
  out[C_SHARED_BYTES] = int(shared_bytes);
  out[C_BLOCKS_PER_SM] = blocks;
  return 0;
}

}  // namespace cloudsc2_occupancy
