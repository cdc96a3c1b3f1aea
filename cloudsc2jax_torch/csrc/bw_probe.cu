// Window-matched bandwidth probe: the TPU kernel of `window_probe`
// (tools/bw_probe.py:78-94, called at :97).
//
// What it computes.  Per level step it reads R rows and writes W rows of
// levels-major (nlev, ncol) f32 arrays:
//   out[j] = in[j % R] * s + in[(j + 1) % R] + work,
// where `work` is zero or, in the compute-weighted mode, a serially
// dependent chain of T tanh and (F - 2T)/2 fused multiply-adds per element,
// seeded from in[0], re-salted from in[t % R] at every step and mixed in at
// 1e-20, so that it is forced and numerically invisible.  Levels run forward
// or, with `rev`, from the last to the first (the adjoint sweep's order).
// The outputs use only the first min(R, W + 1) inputs; on the TPU the other
// windows are fetched all the same, here a load whose value is unused would
// be dropped by the compiler, so the remaining inputs are summed into out[0]
// at weight zero: every one of the R rows is read, and the result for finite
// data is unchanged (without fast math `x * 0.0f` is not folded away).
//
// It has the access shape of the physics kernels ON THIS CARD, not the TPU's
// (S, 128) windows over a (block, level) grid: one thread per column, a loop
// over the levels, per level R coalesced row reads and W coalesced row
// writes, nothing else.  Its time at a kernel's mix (NL 15x8, TL 16x19,
// reverse adjoint 27x16, ...) is the ceiling of that access shape, the
// denominator the kernels' times are judged against (PERF.md); with the
// chain it is the ceiling of the shape at the kernel's arithmetic density.
//
// R, W, T and F are compile-time constants, given as -D defines
// (BW_PROBE_R, _W, _TANH, _FLOPS), one build per mix: the R values of a
// level live in registers, and a register array indexed at run time would go
// to local memory, which the probe would then measure.  `rev` and `s` are
// run-time arguments.  What bounds it is bytes by construction without the
// chain, and operations with a long enough one.

#include <cuda_runtime.h>

#include <cstdint>

#if !defined(BW_PROBE_R) || !defined(BW_PROBE_W)
#error "build with -DBW_PROBE_R=<reads> -DBW_PROBE_W=<writes>"
#endif
#ifndef BW_PROBE_TANH
#define BW_PROBE_TANH 0
#endif
#ifndef BW_PROBE_FLOPS
#define BW_PROBE_FLOPS 0
#endif

namespace {

constexpr int kThreads = 128;
constexpr int R = BW_PROBE_R;
constexpr int W = BW_PROBE_W;
constexpr int kTanh = BW_PROBE_TANH;
constexpr int kFlops = BW_PROBE_FLOPS;
constexpr int kFma = (kFlops - 2 * kTanh > 0 ? kFlops - 2 * kTanh : 0) / 2;
static_assert(R >= 1 && W >= 1 && kTanh >= 0 && kFlops >= 0, "bad mix");

struct Args {
  const float* in[R];
  float* out[W];
};

__global__ void __launch_bounds__(kThreads)
    bw_probe_kernel(const __grid_constant__ Args a, const float s,
                    const int ncol, const int nlev, const int rev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  for (int k = 0; k < nlev; ++k) {
    const int64_t i = int64_t(rev ? nlev - 1 - k : k) * ncol + col;
    float v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = __ldg(a.in[j] + i);
    float work = 0.0f;
    if (kTanh > 0 || kFlops > 0) {
      work = v[0];
#pragma unroll
      for (int t = 0; t < kTanh; ++t) work = tanhf(work + v[t % R] * 1e-3f);
#pragma unroll
      for (int f = 0; f < kFma; ++f) work = work * 1.0000001f + v[f % R] * 1e-6f;
      work = work * 1e-20f;
    }
    float unused = 0.0f;
#pragma unroll
    for (int j = W + 1; j < R; ++j) unused += v[j];
    work = work + unused * 0.0f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a.out[j][i] = v[j % R] * s + v[(j + 1) % R] + work;
    }
  }
}

}  // namespace

extern "C" {

// Writes the mix this library was built for: R, W, tanh and flops per
// element.
int bw_probe_abi(int* counts) {
  counts[0] = R;
  counts[1] = W;
  counts[2] = kTanh;
  counts[3] = kFlops;
  return 0;
}

// Launches the probe on `stream` and returns the cudaError_t of the launch.
// `in` holds R and `out` W device pointers to (nlev, ncol) f32 arrays.
int bw_probe_f32(const void* const* in, void* const* out, double s, int ncol,
                 int nlev, int rev, void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  Args a = {};
  for (int j = 0; j < R; ++j) a.in[j] = static_cast<const float*>(in[j]);
  for (int j = 0; j < W; ++j) a.out[j] = static_cast<float*>(out[j]);
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  bw_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, float(s), ncol, nlev, rev);
  return int(cudaGetLastError());
}

}  // extern "C"
