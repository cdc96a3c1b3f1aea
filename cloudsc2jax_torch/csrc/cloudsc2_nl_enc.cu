// CLOUDSC2 nonlinear sweep over 16-bit-encoded level streams: the TPU kernel
// `_stream_kernel(encoded="lev"|"full")`
// (cloudsc2jax/pallas/cloudsc2_kernel.py:348, decode :361-403) as
// `cloudsc2_pallas_encoded` (cloudsc2jax/pallas/experiments.py:164) runs it.
//
// What it computes is cloudsc2_nl.cu's sweep on the DECODED trajectory: each
// value of an encoded stream is float(payload) * scale[level][stream] +
// offset[level][stream], the payload an int16 or (the convert-cost control)
// a bfloat16 holding the same rounded anomaly; the outputs are exact f32.
// pqs is SATUR of the decoded pt and pap for a `fuse_satur` encoding (15
// streams) and a stream of its own otherwise (16).  Any stream may be
// encoded, plu and paph included: plu(k+1) decodes with the row of level
// min(k+1, nlev-1), paph(k+1) with row k+1 of paph's nlev+1 rows, and the
// decoded paph(k+1) is carried over as the next level's paph(k).  The
// tropopause eta and the surface pressure arrive exact, computed before
// quantisation.  The schedule is cloudsc2_nl_sweep.cuh's, unchanged; only
// the load differs (cloudsc2_load::LevelMajorT in cloudsc2_load.cuh, which
// also says why the decode is not one FMA).  Float only.
//
// Traffic per level and column with the default encoding (12 16-bit + 3 f32
// streams): 36 B read where the exact sweep reads 60, the 8 f32 writes
// unchanged.  The exact sweep is bound by its bytes on this card
// (cloudsc2_nl_sweep.cuh), so here, unlike in the TL and AD bodies, fewer
// bytes could pay, once the policy's own work is off the level loop: the
// decode table is level-major, one 128 B line per level (a 15-stream
// encoding's padded with a 16th pair), which each block stages into its
// shared memory before its sweep (17.7 KB at 137 levels) and reads as
// uniform-address LDS.128 pairs, so that every global load of a level is
// issued before the first decode waits on one; the default encoding's mask
// of each stream order has a kernel in which it is a compile-time constant
// (one load per stream of its own width, pq, plu and paph exact loads, no
// select, paph's carry a plain f32); any other mask runs the runtime-mask
// kernel, which keeps the whole contract.  Its register budget is a define,
// CLOUDSC2_NL_ENC_MIN_BLOCKS_F32 (blocks of 128 threads per SM;
// probes/nl_enc_ab.py sweeps it).  What still bounds it, and the times:
// PERF.md.
//
// A library of its own, so that the exact kernels of cloudsc2_nl.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_nl_sweep.cuh"

// 10 blocks (48 registers, no spills): the fastest of 6-12 for the fixed and
// the runtime kernel on an NVIDIA H100 (probes/nl_enc_ab.py sweep; PERF.md)
#ifndef CLOUDSC2_NL_ENC_MIN_BLOCKS_F32
#define CLOUDSC2_NL_ENC_MIN_BLOCKS_F32 10
#endif

namespace {

using namespace cloudsc2_nl;

// The NL sweep takes any of its streams encoded, plu and paph included.
constexpr unsigned kNlNeverEncoded = 0u;

// The default encoding's masks (keep_f32 pq, plu and paph), one per stream
// order: each has a kernel of its own.
constexpr unsigned kDefaultMaskFused = 0x1FFDu;     // 15 streams, pqs computed
constexpr unsigned kDefaultMaskStreamed = 0x3FFDu;  // 16 streams, pqs streamed

template <bool PQS_STREAM>
constexpr unsigned default_mask() {
  using O = Order<PQS_STREAM>;
  return ((1u << (O::PAPH + 1)) - 1u) &
         ~(1u << O::PQ | 1u << O::PLU | 1u << O::PAPH);
}
static_assert(default_mask<false>() == kDefaultMaskFused &&
                  default_mask<true>() == kDefaultMaskStreamed,
              "the default masks follow the stream orders");
static_assert(Order<true>::PAPH < cloudsc2_load::kTableStreams,
              "a row of the level-major table holds every stream's pair");

// The policy: the mask FIXED as a compile-time constant (0: read at run
// time), the payload, and the table read from the block's shared memory.
template <unsigned FIXED, bool BF16>
using Policy = cloudsc2_load::LevelMajorT<FIXED, kNlNeverEncoded, BF16, true>;

template <bool EVAP, bool PQS_STREAM, bool BF16, unsigned FIXED>
__global__ void __launch_bounds__(kThreads, CLOUDSC2_NL_ENC_MIN_BLOCKS_F32)
    cloudsc2_nl_enc_kernel(const __grid_constant__ Args<float> a, const int ncol,
                           const int nlev) {
  Policy<FIXED, BF16>::stage(a.table, a.table_rows);
  sweep<float, EVAP, PQS_STREAM, false, Policy<FIXED, BF16>>(a, ncol, nlev);
}

// Launches one instantiation with the table's rows in dynamic shared memory,
// allowing more than the default 48 KB where the levels need it.
template <typename Kernel>
int launch_kernel(Kernel kernel, const Args<float>& a, int ncol, int nlev,
                  cudaStream_t s) {
  const size_t shared =
      size_t(a.table_rows) * cloudsc2_load::kTableStreams * sizeof(float2);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<blocks_for(ncol, kThreads), kThreads, shared, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

template <bool EVAP, bool PQS_STREAM, unsigned FIXED>
int launch_variant(const Args<float>& a, int ncol, int nlev, bool bf16,
                   cudaStream_t s) {
  return bf16 ? launch_kernel(cloudsc2_nl_enc_kernel<EVAP, PQS_STREAM, true, FIXED>,
                              a, ncol, nlev, s)
              : launch_kernel(cloudsc2_nl_enc_kernel<EVAP, PQS_STREAM, false, FIXED>,
                              a, ncol, nlev, s);
}

template <bool PQS_STREAM, unsigned FIXED>
int launch_mask(const Args<float>& a, int ncol, int nlev, bool bf16, bool evap,
                cudaStream_t s) {
  return evap ? launch_variant<true, PQS_STREAM, FIXED>(a, ncol, nlev, bf16, s)
              : launch_variant<false, PQS_STREAM, FIXED>(a, ncol, nlev, bf16, s);
}

// `fixed` asks for the kernel of the default mask, which takes no other.
template <bool PQS_STREAM>
int launch(const void* const* in, void* const* out, const double* consts,
           const void* levels, unsigned enc_mask, bool fixed, bool bf16,
           int ncol, int nlev, bool evap, cudaStream_t s) {
  using O = Order<PQS_STREAM>;
  constexpr unsigned kDefault = default_mask<PQS_STREAM>();
  if (enc_mask >> (O::PAPH + 1) || (fixed && enc_mask != kDefault)) {
    return int(cudaErrorInvalidValue);
  }
  Args<float> a = {};
  for (int j = 0; j < O::N; ++j) a.in[j] = static_cast<const float*>(in[j]);
  fill_outputs(a, out, consts);
  a.table = static_cast<const float2*>(levels);
  a.table_rows = nlev + 1;
  a.enc_mask = enc_mask;
  return fixed ? launch_mask<PQS_STREAM, kDefault>(a, ncol, nlev, bf16, evap, s)
               : launch_mask<PQS_STREAM, 0u>(a, ncol, nlev, bf16, evap, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays: streams without and with pqs,
// outputs, constants; so the caller can check that it was built against the
// same layout.
int cloudsc2_nl_enc_abi(int* counts) {
  counts[0] = Order<false>::N;
  counts[1] = Order<true>::N;
  counts[2] = N_OUTPUT;
  counts[3] = N_CONST;
  return 0;
}

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds the encoding's streams in its own order (15 without pqs, 16 with
// it when `pqs_stream`), then ceta, zscalm, ztrpaus, paph_sfc; in[j] points
// to (nlev, ncol) 16-bit payloads (int16, or bfloat16 when `payload_bf16`)
// where bit j of `enc_mask` is set and to f32 values otherwise, paph with
// nlev+1 rows; `levels` is the level-major (nlev+1, 16, 2) f32 [scale,
// offset] table on the device, 16 B aligned; `fixed_mask` runs the kernel of
// the stream order's default mask (kDefaultMaskFused, kDefaultMaskStreamed),
// and is refused for any other mask; `out` holds N_OUTPUT f32 pointers;
// `consts` N_CONST host doubles.
int cloudsc2_nl_enc_f32(const void* const* in, void* const* out,
                        const double* consts, const void* levels,
                        unsigned enc_mask, int fixed_mask, int payload_bf16,
                        int pqs_stream, int ncol, int nlev, int evap,
                        void* stream) {
  if (ncol <= 0 || nlev <= 0 || levels == nullptr ||
      reinterpret_cast<uintptr_t>(levels) % 16 != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fixed = fixed_mask != 0, bf16 = payload_bf16 != 0, ev = evap != 0;
  return pqs_stream ? launch<true>(in, out, consts, levels, enc_mask, fixed,
                                   bf16, ncol, nlev, ev, s)
                    : launch<false>(in, out, consts, levels, enc_mask, fixed,
                                    bf16, ncol, nlev, ev, s);
}

}  // extern "C"
