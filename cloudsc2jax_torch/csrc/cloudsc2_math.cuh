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
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T xmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
