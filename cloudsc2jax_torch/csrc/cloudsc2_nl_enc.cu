// CLOUDSC2 nonlinear sweep over 16-bit-encoded level streams: the TPU kernel
// `_stream_kernel(encoded="lev"|"full")`
// (cloudsc2jax/pallas/cloudsc2_kernel.py:348, decode :361-403) as
// `cloudsc2_pallas_encoded` (cloudsc2jax/pallas/experiments.py:164) runs it.
//
// What it computes is cloudsc2_nl.cu's sweep on the DECODED trajectory: each
// value of an encoded stream is float(payload) * scale[stream][level] +
// offset[stream][level], the payload an int16 or (the convert-cost control)
// a bfloat16 holding the same rounded anomaly; the outputs are exact f32.
// pqs is SATUR of the decoded pt and pap for a `fuse_satur` encoding (15
// streams) and a stream of its own otherwise (16).  Any stream may be
// encoded, plu and paph included: plu(k+1) decodes with the row of level
// min(k+1, nlev-1), paph(k+1) with row k+1 of paph's nlev+1 rows, and the
// decoded paph(k+1) is carried over as the next level's paph(k).  The
// tropopause eta and the surface pressure arrive exact, computed before
// quantisation.  The schedule is cloudsc2_nl_sweep.cuh's, unchanged; only
// the load differs (cloudsc2_load::EncodedT in cloudsc2_load.cuh, which also
// says why the decode is not one FMA).  Float only.
//
// Traffic per level and column with the default encoding (12 16-bit + 3 f32
// streams): 36 B read where the exact sweep reads 60, the 8 f32 writes
// unchanged.  The exact sweep is bound by its bytes on this card
// (cloudsc2_nl_sweep.cuh), so fewer bytes could pay here where they did not
// for the TL and AD bodies: PERF.md holds the times.
//
// A library of its own, so that the exact kernels of cloudsc2_nl.cu keep
// their code, and so that its nvcc run overlaps the others'.

#include "cloudsc2_nl_sweep.cuh"

namespace {

using namespace cloudsc2_nl;

// Blocks per SM the register budget must allow.  The policy's loads (15 or
// 16 values, as many [scale, offset] rows, the selects) take the kernel to
// 126-164 registers when ptxas is left alone, and the sweep then runs at 4
// blocks per SM; 10 blocks cap it at 48 registers with 8-32 B of spills,
// the fastest of the budgets measured on an NVIDIA H100 (the table in
// PERF.md under "Encoded NL", from cloudsc2jax_torch/probes/nl_enc_blocks.py,
// which rebuilds a copy of this file per budget and times it).
constexpr int kMinBlocks = 10;

template <bool EVAP, bool PQS_STREAM, bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cloudsc2_nl_enc_kernel(const __grid_constant__ Args<float> a, const int ncol,
                           const int nlev) {
  sweep<float, EVAP, PQS_STREAM, false, cloudsc2_load::EncodedT<BF16>>(a, ncol,
                                                                      nlev);
}

template <bool EVAP, bool PQS_STREAM>
int launch_variant(const Args<float>& a, int ncol, int nlev, bool bf16,
                   cudaStream_t s) {
  const unsigned blocks = blocks_for(ncol, kThreads);
  if (bf16) {
    cloudsc2_nl_enc_kernel<EVAP, PQS_STREAM, true><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_nl_enc_kernel<EVAP, PQS_STREAM, false><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

template <bool PQS_STREAM>
int launch(const void* const* in, void* const* out, const double* consts,
           const void* table, unsigned enc_mask, bool bf16, int ncol, int nlev,
           int evap, cudaStream_t s) {
  using O = Order<PQS_STREAM>;
  if (enc_mask >> (O::PAPH + 1)) return int(cudaErrorInvalidValue);
  Args<float> a = {};
  for (int j = 0; j < O::N; ++j) a.in[j] = static_cast<const float*>(in[j]);
  fill_outputs(a, out, consts);
  a.table = static_cast<const float2*>(table);
  a.table_rows = nlev + 1;
  a.enc_mask = enc_mask;
  return evap ? launch_variant<true, PQS_STREAM>(a, ncol, nlev, bf16, s)
              : launch_variant<false, PQS_STREAM>(a, ncol, nlev, bf16, s);
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
// nlev+1 rows; `table` is the (streams, nlev+1, 2) f32 [scale, offset] table
// on the device; `out` holds N_OUTPUT f32 pointers; `consts` N_CONST host
// doubles.
int cloudsc2_nl_enc_f32(const void* const* in, void* const* out,
                        const double* consts, const void* table,
                        unsigned enc_mask, int payload_bf16, int pqs_stream,
                        int ncol, int nlev, int evap, void* stream) {
  if (ncol <= 0 || nlev <= 0 || table == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pqs_stream
             ? launch<true>(in, out, consts, table, enc_mask, payload_bf16 != 0,
                            ncol, nlev, evap, s)
             : launch<false>(in, out, consts, table, enc_mask,
                             payload_bf16 != 0, ncol, nlev, evap, s);
}

}  // extern "C"
