// How a sweep reads one value of an input stream: the only point where the
// exact and the 16-bit-encoded kernels differ.  Used by the TL and AD sweeps
// (cloudsc2_tl_sweep.cuh, cloudsc2_ad_sweep.cuh) and by the NL sweep
// (cloudsc2_nl_sweep.cuh).
//
// The TPU kernels `_stream_kernel`, `_tl_kernel` and `_rev_kernel` took
// `encoded=...` (cloudsc2jax/pallas/cloudsc2_kernel.py:361-403,
// cloudsc2jax/pallas/tlad_kernel.py:154-167, :224, :524) and decoded whole
// (S, 128) windows against lane-broadcast [scale, offset] rows fetched by a
// BlockSpec of their own.  Here a thread reads one element and two scalars
// per stream and level.
//
// A sweep takes the policy as a template argument and reads a level in two
// steps: `Load::fetch(args, stream, index)` for every stream, then
// `Load::value(args, stream, row, fetched)` for every stream.  `args` is the
// sweep's own Args (it holds `in`, and for an encoded policy `table` and
// `enc_mask`).  The two steps keep a level's loads back to back: a decode
// written inside the branch that picks the load's width would make each
// stream wait for its own load before the next one is issued.
//
// Stream numbering.  `stream` is the index into the sweep's own `in`: bit
// `stream` of `enc_mask` and pair `stream` of a table row belong to
// `in[stream]`.  Each sweep orders its first streams as the encoding it takes
// does (EncodedInputs.names in kernels/experiments.py): the TL and AD sweeps
// the 16 streams of a `fuse_satur=False` encoding (pt pq pqs pap ... plu
// paph), the NL sweep those or, where it computes pqs itself, the 15 of a
// `fuse_satur=True` encoding (cloudsc2_nl::Order).  `row` is the level the
// value belongs to: min(k+1, nlev-1) for plu(k+1), k+1 of paph's nlev+1
// rows for paph(k+1).
//
// The encoded policy decodes a payload q to float(q) * scale + offset,
// multiply and add rounded separately (`__fmul_rn`, `__fadd_rn`): nvcc would
// contract them into one FMA, and the decoded trajectory would then differ
// in its last bit from the plain PyTorch decode the kernel is held against.
// Payload rows are (nlev, ncol) 16-bit with no padding, so with an odd ncol a
// row starts on an odd half-word: the loads are scalar 16-bit loads, never
// vectorised.
//
// * Exact: `__ldg` of T, and the value is what was fetched.  The exact
//   kernels compile to what they were before the policy existed.
// * LevelMajorT<FIXED, NEVER, BF16, SHARED> (every encoded sweep): the
//   table is level-major (one level's 16 [scale, offset] pairs are one 128 B
//   line, read as float4 pairs), so a warp's reads of it at one level touch
//   one line, not 16; read from device memory (SHARED false), or from the
//   block's copy in shared memory (SHARED).  The streams in NEVER are Exact at compile
//   time: no table read, no select.  A mask fixed at compile time (FIXED)
//   makes every stream's load one load of its own width, and a kept stream
//   an exact load, with no select; a mask read at run time (FIXED == 0)
//   picks each load's width and the decoded or the fetched value by bit
//   `stream` of `args.enc_mask`.  `fetch` carries a payload in the bits of
//   the float it returns: an int16 sign-extended, or (BF16) a bfloat16 as
//   the float it denotes.
//   - EncodedLevelsT (the TL and AD sweeps, int16 payloads, the table in
//     device memory): pq, plu and paph are never encoded (kNeverEncoded; the
//     launchers refuse a mask that sets them); the default encoding's mask
//     (kDefaultMask) has a kernel of its own, any other mask runs the
//     runtime-mask kernel.  EncodedLevelsBf16T: the same for bfloat16
//     payloads, in libraries of their own.
//   - The NL sweep (cloudsc2_nl_enc.cu, the table in shared memory): any
//     stream may be encoded (NEVER is empty), either payload; the default
//     encoding's mask of each stream order has a kernel of its own.
//   Measured on an NVIDIA H100 against the stream-major table read through
//   `__ldg` before it (15 or 16 lines per warp and level, two loads and a
//   select per stream), for the TL and AD sweeps against the table in the
//   kernel's parameter block (uniform constant-bank loads), and for the NL
//   sweep between device and shared memory: PERF.md.

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
// streams encoded; the NL sweep takes any stream encoded (cloudsc2_nl_enc.cu).
constexpr unsigned kNeverEncoded = 1u << 1 | 1u << 14 | 1u << 15;

// The pairs of a row of the level-major table (the encoded TL and AD
// sweeps' 16 streams; the NL sweep's 15 or 16), and the TL and AD sweeps'
// default mask: every stream but the never-encoded ones holds int16 payloads.
constexpr int kTableStreams = 16;
constexpr unsigned kDefaultMask = ((1u << kTableStreams) - 1u) & ~kNeverEncoded;

// The level-major policy of the encoded sweeps.  `args.table` is the
// level-major (nlev+1, 16, 2) f32 [scale, offset] table in device memory, 16
// B aligned: row k is one 128 B line, read as float4 pairs of streams (a
// 15-stream NL encoding's table is padded with a 16th pair (1, 0), so that
// every row is a whole line).  NEVER holds the streams the sweep never takes
// encoded: for them the policy is Exact at compile time, no table read, no
// select.  FIXED != 0 is a mask fixed at compile time (the launcher picks
// that instantiation for that mask; `args.enc_mask` is then not read);
// FIXED == 0 reads `args.enc_mask` at run time.  BF16: the payloads are
// bfloat16, whose float is the payload's bits shifted into the high half of
// an f32 (a shift in place of the int16's convert); else int16.  SHARED: the
// kernel stages the table into its dynamic shared memory (`stage`, once per
// block, before its sweep) and `value` reads it there, one uniform-address
// LDS.128 per pair; else `value` reads it from device memory through L1.
template <unsigned FIXED, unsigned NEVER, bool BF16, bool SHARED>
struct LevelMajorT {
  static __device__ __forceinline__ constexpr bool never(const int stream) {
    return ((NEVER >> stream) & 1u) ||
           (FIXED != 0u && !((FIXED >> stream) & 1u));
  }
  template <typename A>
  static __device__ __forceinline__ bool encoded(const A& a, const int stream) {
    return !never(stream) && (FIXED != 0u || ((a.enc_mask >> stream) & 1u));
  }
  // SHARED only: the table's copy in the block's dynamic shared memory
  static __device__ __forceinline__ float4* shared_table() {
    extern __shared__ float4 cloudsc2_load_table[];
    return cloudsc2_load_table;
  }
  // SHARED only: every thread of the block copies its share of the table's
  // `rows` rows, then waits for the others
  static __device__ __forceinline__ void stage(const float2* table,
                                               const int rows) {
    static_assert(SHARED, "only a policy that reads shared memory stages");
    const float4* from = reinterpret_cast<const float4*>(table);
    float4* to = shared_table();
    for (int j = threadIdx.x; j < rows * (kTableStreams / 2); j += blockDim.x) {
      to[j] = __ldg(from + j);
    }
    __syncthreads();
  }
  template <typename A>
  static __device__ __forceinline__ float4 table_pair(const A& a, const int row,
                                                      const int stream) {
    if constexpr (SHARED) {
      return shared_table()[row * (kTableStreams / 2) + stream / 2];
    } else {
      return __ldg(reinterpret_cast<const float4*>(a.table) +
                   row * (kTableStreams / 2) + stream / 2);
    }
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
    if (never(stream)) return fetched;
    const float4 pair = table_pair(a, row, stream);
    const float scale = stream & 1 ? pair.z : pair.x;
    const float offset = stream & 1 ? pair.w : pair.y;
    const float q = BF16 ? fetched : float(__float_as_int(fetched));
    const float decoded = __fadd_rn(__fmul_rn(q, scale), offset);
    return encoded(a, stream) ? decoded : fetched;
  }
};

// The encoded TL and AD sweeps' policy: int16 payloads, pq, plu and paph
// never encoded.  A type of its own, so that the kernels' names, and so
// their code, are what they were before the NL sweep shared the policy.
template <unsigned FIXED = 0u>
struct EncodedLevelsT : LevelMajorT<FIXED, kNeverEncoded, false, false> {};

using EncodedLevels = EncodedLevelsT<>;

// The same sweeps' policy for bfloat16 payloads (`encode_blocked_inputs(...,
// payload_dtype=bfloat16)`, experiments.py:103, :146, which
// `cloudsc2_pallas_tl_encoded` and `cloudsc2_pallas_ad_encoded` take as they
// take int16): the shift decode of the encoded NL sweep, pq, plu and paph
// never encoded.  Used by cloudsc2_tl_enc_bf16.cu and cloudsc2_ad_enc_bf16.cu.
template <unsigned FIXED = 0u>
struct EncodedLevelsBf16T : LevelMajorT<FIXED, kNeverEncoded, true, false> {};

}  // namespace cloudsc2_load
