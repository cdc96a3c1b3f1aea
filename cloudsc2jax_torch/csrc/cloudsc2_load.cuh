// How the TL and AD sweeps read one value of an input stream: the only
// point where the exact and the int16-encoded kernels differ.
//
// The TPU kernels `_tl_kernel` and `_rev_kernel` took `encoded=True`
// (cloudsc2jax/pallas/tlad_kernel.py:154-167, :224, :524) and decoded
// whole (S, 128) windows against lane-broadcast [scale, offset] rows
// fetched by a BlockSpec of their own.  Here a thread reads one element
// and two scalars: the table is the compact (16, nlev+1, 2) f32 array,
// 17.7 KB at 137 levels, read through the read-only path; a warp's 32
// threads read the same row, so the load is one broadcast.
//
// A sweep takes the policy as a template argument and reads a level in two
// steps: `Load::fetch(args, stream, index)` for every stream, then
// `Load::value(args, stream, row, fetched)` for every stream.  `args` is the
// sweep's own Args (it holds `in`, and for Encoded `table`, `table_rows`,
// `enc_mask`).  The two steps keep a level's loads back to back: a decode
// written inside the branch that picks the load's width would make each
// stream wait for its own load before the next one is issued.
//
// * Exact: `__ldg` of T, and the value is what was fetched.  The exact
//   kernels compile to what they were before the policy existed.
// * Encoded (float only): bit `stream` of `args.enc_mask` says whether the
//   stream holds int16 payloads or f32 values, the same for the whole grid;
//   a branch picks each load's width.  `fetch` carries an int16 payload,
//   sign-extended, in the bits of the float it returns.  `value` reads the
//   table row of every stream and selects: an int16 value decodes to
//   float(q) * scale[stream][row] + offset[stream][row], multiply and add
//   rounded separately (`__fmul_rn`, `__fadd_rn`): nvcc would contract
//   them into one FMA, and the decoded trajectory would then differ in its
//   last bit from the plain PyTorch decode the kernel is held against.
//   Payload rows are (nlev, ncol) int16 with no padding, so with an odd
//   ncol a row starts on an odd half-word: the loads are scalar 16-bit
//   loads, never vectorised.  A variant with the default encoding's mask
//   as a compile-time constant (no branch, no table read for a kept
//   stream) measured no better on an NVIDIA H100: the TL sweep slower, the
//   AD sweep faster, the pair the same (PERF.md); it was not kept.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cloudsc2_load {

struct Exact {
  template <typename T, typename A>
  static __device__ __forceinline__ T fetch(const A& a, const int stream,
                                            const int64_t i) {
    return __ldg(a.in[stream] + i);
  }
  template <typename T, typename A>
  static __device__ __forceinline__ T value(const A&, const int /*stream*/,
                                            const int /*row*/, const T fetched) {
    return fetched;
  }
};

// Streams 0-15 are pt pq pqs pap pl pi plude pmfu pmfd ten_t ten_q ten_l
// ten_i psupsat plu paph; pq (1), plu (14) and paph (15) are never encoded.
constexpr unsigned kNeverEncoded = 1u << 1 | 1u << 14 | 1u << 15;

struct Encoded {
  template <typename A>
  static __device__ __forceinline__ bool encoded(const A& a, const int stream) {
    return (a.enc_mask >> stream) & 1u;
  }
  template <typename T, typename A>
  static __device__ __forceinline__ T fetch(const A& a, const int stream,
                                            const int64_t i) {
    static_assert(sizeof(T) == sizeof(float), "encoded streams decode to float");
    if (encoded(a, stream)) {
      return __int_as_float(
          int(__ldg(reinterpret_cast<const int16_t*>(a.in[stream]) + i)));
    }
    return __ldg(a.in[stream] + i);
  }
  template <typename T, typename A>
  static __device__ __forceinline__ T value(const A& a, const int stream,
                                            const int row, const T fetched) {
    const float2 t = __ldg(a.table + stream * a.table_rows + row);
    const float decoded =
        __fadd_rn(__fmul_rn(float(__float_as_int(fetched)), t.x), t.y);
    return encoded(a, stream) ? decoded : fetched;
  }
};

}  // namespace cloudsc2_load
