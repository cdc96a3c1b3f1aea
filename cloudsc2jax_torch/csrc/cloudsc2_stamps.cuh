// Per-warp time stamps of the traced twins of the NL, TL and AD sweeps
// (cloudsc2_nl.cu, cloudsc2_tl.cu, cloudsc2_ad.cu).  A twin runs the shipped
// kernel's sweep on the same arguments and takes one more parameter, the
// warps' records; lane 0 of each warp writes the record of its warp at
// records[blockIdx.x * warps a block + warp]: when the warp starts,
// %globaltimer (the card's global nanosecond clock, one for every SM) and
// the SM it runs on (`open`); after the warp's last level and a
// __syncwarp() of its lanes, how long the whole warp took (`close`).  A lane
// whose column lies past ncol leaves at once, as in the shipped kernel, so a
// warp whose columns all lie past ncol keeps the record `open` wrote, of no
// duration.  The start is read back from memory at the end, so that no
// register holds it across the level loop.  The shipped kernels take no
// such parameter: their code is not touched.
//
// Where the stamps go bears on the twin's code beyond them: ptxas gave the
// NL twin twice the shipped instance's registers (96 against 48 in f32)
// wherever the lanes past ncol ran any code before leaving (a record
// written for them, or a __syncwarp they would meet), and the shipped
// instance's count where they leave at once and the stamps are only at the
// kernel's start and after its level loop.
//
// cloudsc2jax_torch/spans.py hands each traced launch a slice of records and
// reduces it (`stamp_counters`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cloudsc2_stamps {

// One warp's record, 16 bytes: RECORD in cloudsc2jax_torch/spans.py.
struct Record {
  unsigned long long start;  // %globaltimer, ns
  unsigned int duration;     // ns from start to the warp's end
  unsigned int smid;         // %smid
};
static_assert(sizeof(Record) == 16, "spans.py reads 16 bytes a record");

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ unsigned int smid() {
  unsigned int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// The calling warp's record in a launch of blocks of THREADS threads.
template <int THREADS>
__device__ __forceinline__ Record* slot(Record* records) {
  return records + int64_t(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
}

// Lane 0 opens the calling warp's record: its start and SM, no duration.
template <int THREADS>
__device__ __forceinline__ void open(Record* records) {
  if ((threadIdx.x & 31) == 0) {
    *reinterpret_cast<ulonglong2*>(slot<THREADS>(records)) =
        make_ulonglong2(globaltimer(), static_cast<unsigned long long>(smid()) << 32);
  }
}

// After the warp's last level: once every lane of the warp that ran the
// sweep (those of columns below ncol; the others have left) is past it,
// lane 0 writes how long the warp took.
template <int THREADS>
__device__ __forceinline__ void close(Record* records, const int64_t col, const int ncol) {
  const int64_t lanes = ncol - (col - (threadIdx.x & 31));
  __syncwarp(lanes >= 32 ? 0xffffffffu : (1u << lanes) - 1u);
  if ((threadIdx.x & 31) == 0) {
    const unsigned long long end = globaltimer();
    Record* r = slot<THREADS>(records);
    const unsigned long long start = *reinterpret_cast<volatile unsigned long long*>(&r->start);
    r->duration = unsigned(end - start);
  }
}

}  // namespace cloudsc2_stamps
