// How a sweep reads one value of an input stream: the only point where the
// exact and the 16-bit-encoded kernels differ.  Used by the TL and AD sweeps
// (cloudsc2_tl_sweep.cuh, cloudsc2_ad_sweep.cuh) and by the NL sweep
// (cloudsc2_nl_sweep.cuh).
//
// The TPU kernels `_stream_kernel`, `_tl_kernel` and `_rev_kernel` took
// `encoded=...` (cloudsc2jax/pallas/cloudsc2_kernel.py:361-403,
// cloudsc2jax/pallas/tlad_kernel.py:154-167, :224, :524) and decoded whole
// (S, 128) windows against lane-broadcast [scale, offset] rows fetched by a
// BlockSpec of their own.  Here a thread reads one element and two scalars:
// the table is the compact (n_streams, nlev+1, 2) f32 array, 17.7 KB for 16
// streams at 137 levels, read through the read-only path; a warp's 32
// threads read the same row, so the load is one broadcast.
//
// A sweep takes the policy as a template argument and reads a level in two
// steps: `Load::fetch(args, stream, index)` for every stream, then
// `Load::value(args, stream, row, fetched)` for every stream.  `args` is the
// sweep's own Args (it holds `in`, and for an encoded policy `table`,
// `table_rows`, `enc_mask`).  The two steps keep a level's loads back to
// back: a decode written inside the branch that picks the load's width would
// make each stream wait for its own load before the next one is issued.
//
// Stream numbering.  `stream` is the index into the sweep's own `in`: bit
// `stream` of `enc_mask` and row `stream` of the table belong to
// `in[stream]`.  Each sweep orders its first streams as the encoding it takes
// does (EncodedInputs.names in kernels/experiments.py): the TL and AD sweeps
// the 16 streams of a `fuse_satur=False` encoding (pt pq pqs pap ... plu
// paph), the NL sweep those or, where it computes pqs itself, the 15 of a
// `fuse_satur=True` encoding (cloudsc2_nl::Order).  `row` is the level the
// value belongs to: min(k+1, nlev-1) for plu(k+1), k+1 of paph's nlev+1
// rows for paph(k+1).
//
// * Exact: `__ldg` of T, and the value is what was fetched.  The exact
//   kernels compile to what they were before the policy existed.
// * EncodedT<BF16> (float only; Encoded = EncodedT<false>): bit `stream` of
//   `args.enc_mask` says whether the stream holds 16-bit payloads or f32
//   values, the same for the whole grid; a branch picks each load's width.
//   `fetch` carries the payload in the bits of the float it returns: an
//   int16 sign-extended, or (BF16) a bfloat16 as the float it denotes, which
//   is a shift in place of the int16's convert.  `value` reads the table row
//   of every stream and selects: a payload q decodes to
//   float(q) * scale[stream][row] + offset[stream][row], multiply and add
//   rounded separately (`__fmul_rn`, `__fadd_rn`): nvcc would contract them
//   into one FMA, and the decoded trajectory would then differ in its last
//   bit from the plain PyTorch decode the kernel is held against.  Payload
//   rows are (nlev, ncol) 16-bit with no padding, so with an odd ncol a row
//   starts on an odd half-word: the loads are scalar 16-bit loads, never
//   vectorised.  A variant with the default encoding's mask as a
//   compile-time constant (no branch, no table read for a kept stream)
//   measured no better on an NVIDIA H100: the TL sweep slower, the AD sweep
//   faster, the pair the same (PERF.md); it was not kept.

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

// The TL and AD sweeps never take pq (1), plu (14) or paph (15) of their 16
// streams encoded; the NL sweep takes any stream encoded.
constexpr unsigned kNeverEncoded = 1u << 1 | 1u << 14 | 1u << 15;

template <bool BF16>
struct EncodedT {
  template <typename A>
  static __device__ __forceinline__ bool encoded(const A& a, const int stream) {
    return (a.enc_mask >> stream) & 1u;
  }
  template <typename T, typename A>
  static __device__ __forceinline__ T fetch(const A& a, const int stream,
                                            const int64_t i) {
    static_assert(sizeof(T) == sizeof(float), "encoded streams decode to float");
    if (encoded(a, stream)) {
      if (BF16) {
        return __uint_as_float(
            unsigned(__ldg(reinterpret_cast<const uint16_t*>(a.in[stream]) + i))
            << 16);
      }
      return __int_as_float(
          int(__ldg(reinterpret_cast<const int16_t*>(a.in[stream]) + i)));
    }
    return __ldg(a.in[stream] + i);
  }
  template <typename T, typename A>
  static __device__ __forceinline__ T value(const A& a, const int stream,
                                            const int row, const T fetched) {
    const float2 t = __ldg(a.table + stream * a.table_rows + row);
    const float q = BF16 ? fetched : float(__float_as_int(fetched));
    const float decoded = __fadd_rn(__fmul_rn(q, t.x), t.y);
    return encoded(a, stream) ? decoded : fetched;
  }
};

using Encoded = EncodedT<false>;

}  // namespace cloudsc2_load
