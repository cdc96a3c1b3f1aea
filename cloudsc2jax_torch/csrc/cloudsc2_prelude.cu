// The tropopause eta of the pre-kernel pass (cloudsc2.F90:314-326): for each
// column, the deepest eta in 0.1 < eta < 0.4 at a temperature inversion of
// ztp1 = pt + ptsphy * ten_t, else 0.1.
//
// It replaces no TPU kernel: the JAX package leaves this masked max over
// levels to XLA (`_Layout.__init__`, cloudsc2jax/pallas/cloudsc2_kernel.py),
// and the port computed it as ten PyTorch passes over all nlev rows, each
// writing a (nlev, ncol) intermediate to device memory, for a (ncol,)
// result (`tropopause_eta_lm`, kernels/cloudsc2_kernel.py, which stays the
// plain version and the reference the card tests hold this kernel to).
//
// What it computes, bit for bit as the plain expression does:
//   ztp1[k]    = pt[k] + T(ptsphy) * ten_t[k]    (PyTorch's mul, then add:
//                two roundings, so __fmul_rn/__fadd_rn and no contraction)
//   cand[k]    = ceta[k] if T(0.1) < ceta[k] < T(0.4) and ztp1[k] > ztp1[k+1]
//                else T(0.1),                    for k <= nlev - 2
//   ztrpaus    = max_k cand[k]
// Every candidate is T(0.1) or above it, so a running maximum that starts at
// T(0.1) and takes a strictly larger candidate is the same value as `amax`.
//
// Only the levels whose eta lies in the band can move the result, so the
// kernel walks the hull [k_lo, k_hi] of those levels (computed once on the
// host from the same comparison in the same dtype) and reads the rows
// k_lo..k_hi+1 of pt and ten_t alone: 21 of 137 rows of each at the IFS's
// 137 levels.  It still tests the band on each level it walks, so the
// result is exact for any ceta whose band levels all lie in the hull,
// monotone or not.  An empty hull (k_lo > k_hi) writes 0.1 everywhere.
//
// What bounds it: bytes.  2 x 21 rows x 4 B a column, no arithmetic to speak
// of; one thread owns one column, so each row load of a warp is one
// coalesced 128 B line, and the level loop is unrolled kUnroll levels deep,
// their loads issued before their compares, so that a thread keeps 2 x
// kUnroll loads in flight.  Both strides of pt and ten_t are arguments, so a
// column slice of a wider array, or any other 2-D layout, is read in place
// (coalesced where the column stride is 1, as the port's arrays have it).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The candidate of level k against the running maximum m: `above` is
// ztp1[k], `below` ztp1[k+1].
template <typename T>
__device__ __forceinline__ T take(T m, T eta, T above, T below) {
  const bool band = eta > T(0.1) && eta < T(0.4);
  return (band && above > below && eta > m) ? eta : m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_prelude_kernel(const T* __restrict__ pt, const T* __restrict__ ten_t,
                            const T* __restrict__ ceta, T* __restrict__ ztrpaus,
                            const T ptsphy, const int ncol, const long long pt_row,
                            const long long pt_col, const long long ten_row,
                            const long long ten_col, const int k_lo, const int k_hi) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncol) return;
  T m = T(0.1);
  if (k_lo <= k_hi) {
    const T* p = pt + col * pt_col + k_lo * pt_row;
    const T* t = ten_t + col * ten_col + k_lo * ten_row;
    T above = add_rn(__ldg(p), mul_rn(ptsphy, __ldg(t)));
    int k = k_lo;
    // levels k..k+kUnroll-1 read rows k+1..k+kUnroll
    for (; k + kUnroll <= k_hi + 1; k += kUnroll) {
      T rp[kUnroll], rt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rp[u] = __ldg(p + (k - k_lo + 1 + u) * pt_row);
        rt[u] = __ldg(t + (k - k_lo + 1 + u) * ten_row);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T below = add_rn(rp[u], mul_rn(ptsphy, rt[u]));
        m = take(m, __ldg(ceta + k + u), above, below);
        above = below;
      }
    }
    for (; k <= k_hi; ++k) {
      const T below = add_rn(__ldg(p + (k - k_lo + 1) * pt_row),
                             mul_rn(ptsphy, __ldg(t + (k - k_lo + 1) * ten_row)));
      m = take(m, __ldg(ceta + k), above, below);
      above = below;
    }
  }
  ztrpaus[col] = m;
}

template <typename T>
int launch(const void* pt, const void* ten_t, const void* ceta, void* ztrpaus,
           double ptsphy, int ncol, long long pt_row, long long pt_col,
           long long ten_row, long long ten_col, int k_lo, int k_hi, void* stream) {
  if (ncol <= 0) return int(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned(ncol) + kThreads - 1) / kThreads;
  cloudsc2_prelude_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pt), static_cast<const T*>(ten_t),
      static_cast<const T*>(ceta), static_cast<T*>(ztrpaus), T(ptsphy), ncol, pt_row,
      pt_col, ten_row, ten_col, k_lo, k_hi);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Writes the launcher's operand counts (row operands read, level operands
// read, column outputs written), so the caller can check that it was built
// against the same layout.
int cloudsc2_prelude_abi(int* counts) {
  counts[0] = 2;  // pt, ten_t
  counts[1] = 1;  // ceta
  counts[2] = 1;  // ztrpaus
  return 0;
}

// Launches the kernel on `stream` and returns the cudaError_t of the launch.
// pt and ten_t are (nlev, ncol), element (k, col) at k * row + col * col
// stride (`pt_row`, `pt_col`, `ten_row`, `ten_col` elements), ceta (nlev,)
// and ztrpaus (ncol,) contiguous; [k_lo, k_hi] (k_hi <= nlev - 2) holds
// every level whose eta lies in the band, empty when k_lo > k_hi.
int cloudsc2_prelude_f32(const void* pt, const void* ten_t, const void* ceta,
                         void* ztrpaus, double ptsphy, int ncol, long long pt_row,
                         long long pt_col, long long ten_row, long long ten_col,
                         int k_lo, int k_hi, void* stream) {
  return launch<float>(pt, ten_t, ceta, ztrpaus, ptsphy, ncol, pt_row, pt_col, ten_row,
                       ten_col, k_lo, k_hi, stream);
}

int cloudsc2_prelude_f64(const void* pt, const void* ten_t, const void* ceta,
                         void* ztrpaus, double ptsphy, int ncol, long long pt_row,
                         long long pt_col, long long ten_row, long long ten_col,
                         int k_lo, int k_hi, void* stream) {
  return launch<double>(pt, ten_t, ceta, ztrpaus, ptsphy, ncol, pt_row, pt_col,
                        ten_row, ten_col, k_lo, k_hi, stream);
}

}  // extern "C"
