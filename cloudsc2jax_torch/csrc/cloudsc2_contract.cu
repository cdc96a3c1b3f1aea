// The output contract's assembly (cloudsc2.F90:694-735): from the sweep's
// rain and snow flux rows, the ten-field contract's flux fields with their
// zero top row and the two enthalpy fluxes, and for a TL image also the two
// flux seed streams of the reverse sweep.
//
// It replaces no TPU kernel: the JAX package leaves this assembly to XLA
// (`unblock_outputs` and `_seed_streams`, cloudsc2jax/pallas/), and the port
// ran it as seven PyTorch passes (`unblock_outputs`: a zero row, two
// `torch.cat`s, then `-pfplsl` and `* rlvtt` for each flux) plus a `mul` and
// a `sub` per flux for the seeds (`seed_streams`).  Those expressions stay
// the plain version (`plain_contract`, kernels/cloudsc2_kernel.py) and the
// reference the card tests hold this kernel to, bit for bit.
//
// What it computes, each flux f in {rain: rlvtt, snow: rlstt}, c = T(L):
//   flux[0]     = +0
//   flux[k+1]   = src[k]                     (copy form only)
//   enth[k]     = (-flux[k]) * c             (PyTorch's neg, then mul: one
//                                             rounding; the top row -0.0)
//   seed[k]     = flux[k+1] - c * enth[k+1]  (mul, then sub: two roundings,
//                                             so __fmul_rn/__fsub_rn and no
//                                             contraction)
// The constants are rounded to T on the host, as PyTorch rounds a Python
// scalar for a tensor of T.
//
// Two forms, one kernel.  In place, `src` is row 1 of `flux` (the sweep wrote
// its flux rows there): the kernel reads the rows once and writes the top
// row, the enthalpy fluxes and the seeds, 4 fields (+2 with seeds) of the
// 327,680 x 137 f32 (179.6 MB) a flux field holds, against the 12 (+10) the
// PyTorch passes move.  As a copy, `src` is a stream of its own and the flux
// rows are written too, 6 fields (+2).
//
// What bounds it: bytes, at no arithmetic to speak of.  The arrays are
// walked flat, row after row; one thread takes kUnroll packs of 16 B (4 f32
// or 2 f64) kThreads apart, issues all of their loads, then computes and
// stores, so a warp moves whole 512 B lines and a thread keeps 2 x kUnroll
// loads in flight.  Where a pointer is not 16 B aligned or a row is not a
// whole number of packs (ncol not a multiple of 4 or 2), the same loop runs
// on single values.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// V values of T moved as one access: 16 B where V > 1.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T>
struct Args {
  const T* src[2];  // rfln, sfln: (nlev, ncol); in place, flux[f] + ncol
  T* flux[2];       // pfplsl, pfplsn: (nlev + 1, ncol)
  T* enth[2];       // pfhpsl, pfhpsn: (nlev + 1, ncol)
  T* seed[2];       // (nlev, ncol), null without seeds
  T c[2];           // rlvtt, rlstt
};

// Pack q of the (nlev + 1) x ncol flat arrays; the first `top` packs are the
// top row.  IN_PLACE writes flux's top row only, SEEDS the seed streams.
template <typename T, int V, bool IN_PLACE, bool SEEDS>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_contract_kernel(const Args<T> a, const long long n, const long long top) {
  using P = Pack<T, V>;
  const long long first = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  P p[2][kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = first + (long long)u * kThreads;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (q < n && q >= top) {
        p[f][u] = reinterpret_cast<const P*>(a.src[f])[q - top];
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[f][u].v[i] = T(0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = first + (long long)u * kThreads;
    if (q >= n) break;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const T c = a.c[f];
      P h, s;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        h.v[i] = mul_rn(-p[f][u].v[i], c);
        if (SEEDS) s.v[i] = sub_rn(p[f][u].v[i], mul_rn(c, h.v[i]));
      }
      if (!IN_PLACE || q < top) reinterpret_cast<P*>(a.flux[f])[q] = p[f][u];
      reinterpret_cast<P*>(a.enth[f])[q] = h;
      if (SEEDS && q >= top) reinterpret_cast<P*>(a.seed[f])[q - top] = s;
    }
  }
}

template <typename T, int V, bool IN_PLACE, bool SEEDS>
int run(const Args<T>& a, int ncol, int nlev, cudaStream_t stream) {
  const long long n = (long long)(nlev + 1) * ncol / V;
  const long long per_block = (long long)kThreads * kUnroll;
  const unsigned blocks = unsigned((n + per_block - 1) / per_block);
  cloudsc2_contract_kernel<T, V, IN_PLACE, SEEDS>
      <<<blocks, kThreads, 0, stream>>>(a, n, (long long)ncol / V);
  return int(cudaGetLastError());
}

template <typename T, int V>
int dispatch(const Args<T>& a, int ncol, int nlev, bool in_place, bool seeds,
             cudaStream_t stream) {
  if (in_place) {
    return seeds ? run<T, V, true, true>(a, ncol, nlev, stream)
                 : run<T, V, true, false>(a, ncol, nlev, stream);
  }
  return seeds ? run<T, V, false, true>(a, ncol, nlev, stream)
               : run<T, V, false, false>(a, ncol, nlev, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* const* src, void* const* flux, void* const* enth,
           void* const* seed, double rlvtt, double rlstt, int ncol, int nlev,
           void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  Args<T> a;
  bool in_place[2];
  bool vec = true;
  const bool seeds = seed[0] != nullptr;
  for (int f = 0; f < 2; ++f) {
    a.src[f] = static_cast<const T*>(src[f]);
    a.flux[f] = static_cast<T*>(flux[f]);
    a.enth[f] = static_cast<T*>(enth[f]);
    a.seed[f] = static_cast<T*>(seed[f]);
    if (a.src[f] == nullptr || a.flux[f] == nullptr || a.enth[f] == nullptr ||
        (a.seed[f] == nullptr) == seeds) {
      return int(cudaErrorInvalidValue);
    }
    in_place[f] = a.src[f] == a.flux[f] + ncol;
    vec = vec && aligned16(a.src[f]) && aligned16(a.flux[f]) && aligned16(a.enth[f]) &&
          (!seeds || aligned16(a.seed[f]));
  }
  if (in_place[0] != in_place[1]) return int(cudaErrorInvalidValue);
  a.c[0] = T(rlvtt);
  a.c[1] = T(rlstt);
  constexpr int kPack = 16 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec && ncol % kPack == 0) {
    return dispatch<T, kPack>(a, ncol, nlev, in_place[0], seeds, s);
  }
  return dispatch<T, 1>(a, ncol, nlev, in_place[0], seeds, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the launcher's pointer arrays (sources, flux fields,
// enthalpy fluxes, seeds), so the caller can check that it was built against
// the same layout.
int cloudsc2_contract_abi(int* counts) {
  counts[0] = 2;  // rfln, sfln
  counts[1] = 2;  // pfplsl, pfplsn
  counts[2] = 2;  // pfhpsl, pfhpsn
  counts[3] = 2;  // the rain and snow seeds
  return 0;
}

// Launches the assembly on `stream` and returns the cudaError_t of the
// launch.  Each array holds the rain's pointer, then the snow's: `src` two
// (nlev, ncol) flux streams, `flux` and `enth` two (nlev + 1, ncol) fields,
// `seed` two (nlev, ncol) streams or two nulls; all contiguous.  Where
// src[f] is flux[f] + ncol (both fluxes, or refused) the flux rows are read
// in place and only the top row of flux is written.
int cloudsc2_contract_f32(const void* const* src, void* const* flux, void* const* enth,
                          void* const* seed, double rlvtt, double rlstt, int ncol,
                          int nlev, void* stream) {
  return launch<float>(src, flux, enth, seed, rlvtt, rlstt, ncol, nlev, stream);
}

int cloudsc2_contract_f64(const void* const* src, void* const* flux, void* const* enth,
                          void* const* seed, double rlvtt, double rlstt, int ncol,
                          int nlev, void* stream) {
  return launch<double>(src, flux, enth, seed, rlvtt, rlstt, ncol, nlev, stream);
}

}  // extern "C"
