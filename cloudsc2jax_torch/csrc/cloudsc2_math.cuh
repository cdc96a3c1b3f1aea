// Scalar math of the generated TL/AD level bodies, in float and double.
//
// The IEEE-accurate library functions (no fast math), as in the NL kernel
// (cloudsc2_nl.cu).  xmax/xmin return NaN when either operand is NaN, as
// torch.maximum/torch.minimum do.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double xtanh(double x) { return tanh(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) { return pow(x, y); }
// a / b from rb = T(1.0) / b, correctly rounded: the product q = a * rb, then
// one step on its residual a - b * q, which the fused multiply-add computes
// exactly; the step, the correction an IEEE division ends with (Markstein's),
// rounds q to the correctly rounded quotient: bit for bit a / b outside
// underflow and overflow, for a multiply and two fused multiply-adds where a
// division takes a reciprocal's refinement, a range check and a branch.
// kernels/emit.py prints it for the quotients of a divisor that divides more
// than one numerator.
__device__ __forceinline__ float xdivr(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
}
__device__ __forceinline__ double xdivr(double a, double b, double rb) {
  const double q = __dmul_rn(a, rb);
  return __fma_rn(__fma_rn(-b, q, a), rb, q);
}
// Shared-memory slots of the AD level bodies (kernels/emit.py parks the
// longest-lived values of a body there instead of in registers): slot j of a
// thread lies kStashStride * j values after the thread's first, so the 32
// threads of a warp touch 32 banks.  The asm is volatile and has no memory
// clobber: the compiler keeps the stores and reads in their printed order
// and cannot forward a stored value into a register, which is the point,
// and may still move arithmetic and device-memory accesses around them.
constexpr int kStashStride = 128;

__device__ __forceinline__ unsigned xshared(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void xstash(float* stash, const int slot, const float v) {
  asm volatile("st.shared.f32 [%0], %1;" :: "r"(xshared(stash + slot * kStashStride)),
               "f"(v));
}
__device__ __forceinline__ void xstash(double* stash, const int slot, const double v) {
  asm volatile("st.shared.f64 [%0], %1;" :: "r"(xshared(stash + slot * kStashStride)),
               "d"(v));
}
__device__ __forceinline__ float xunstash(float* stash, const int slot) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v)
               : "r"(xshared(stash + slot * kStashStride)));
  return v;
}
__device__ __forceinline__ double xunstash(double* stash, const int slot) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v)
               : "r"(xshared(stash + slot * kStashStride)));
  return v;
}
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T xmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
