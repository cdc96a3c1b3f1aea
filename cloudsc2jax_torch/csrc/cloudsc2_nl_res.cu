// CLOUDSC2 nonlinear sweep with its inputs staged through shared memory: the
// TPU kernel `_resident_kernel` (cloudsc2jax/pallas/cloudsc2_kernel.py:424),
// as `cloudsc2_pallas(mode="resident")` (:804-828) runs it.
//
// What it computes: the NL sweep with pqs READ as a stream (the TPU entry
// refuses fuse_satur in this mode, :764), 16 input streams, 8 outputs, no
// checkpoints; the level body is cloudsc2_nl_sweep.cuh's `level`, so the
// results are those of the checkpointing forward kernel (cloudsc2_nl.cu).
//
// What made it a kernel of its own on the TPU: all levels of a column block
// lie in VMEM before the level loop reads them, and the loop reads on-chip
// memory only.  The VMEM block shapes do not carry over.  On this card a
// block of `tile` threads owns `tile` columns, and a ring of `depth` level
// slots in dynamic shared memory holds, per slot, the 16 values of each of
// its columns for one level (the 14 level rows, plu(k+1) clamped at the last
// level, paph(k+1); paph(0) goes straight to a register).  Each thread
// copies its own column's values with asynchronous copies (`cp.async` of 4
// or 8 bytes) into slots that only it reads, one commit group per level, and
// waits for a level's group before it consumes the level: no barrier is
// needed, and a thread past the last column of a ragged block returns at
// once.  `depth` levels are in flight ahead of the arithmetic; a slot is
// refilled with level k + depth after level k's values have been consumed.
// The carry stays in registers and the outputs go straight to device memory.
// `depth >= nlev` is the TPU schedule to the letter: every level is resident
// before level 0 is computed, after one wait.
//
// Ring size: 16 streams x sizeof(T) per column and level, 8 KB per level at
// 128 f32 columns.  `tile` and `depth` are launch parameters of one kernel;
// the launcher opts into as much dynamic shared memory as the ring needs and
// returns an error when a block cannot have it (227 KB on an H100: with
// depth = nlev = 137, 26 f32 or 13 f64 columns).  The wait takes an
// immediate operand, so a ring deeper than kMaxPending + 1 levels that is
// not fully resident runs with kMaxPending + 1 levels of lookahead.
//
// What bounds it on this card: device-memory bytes, as for the other NL
// sweeps (16 reads and 8 writes per level and column, 96 B in f32).  Whether
// staging the loads ahead of the arithmetic moves those bytes faster than the
// plain loads of cloudsc2_nl.cu is what this kernel measures: PERF.md holds
// the times.  Bulk copies by the tensor memory accelerator with mbarriers
// are later work.

#include "cloudsc2_nl_sweep.cuh"

namespace {

using namespace cloudsc2_nl;
using O = Order<true>;

constexpr int kMaxTile = 256;
constexpr int kStaged = O::PAPH + 1;  // streams staged per level
constexpr int kMaxPending = 15;
static_assert(int(X_PSUPSAT) + 1 == int(O::PLU) && int(X_PLU_K1) == int(O::PLU),
              "stream j < PLU is value j");

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Waits until at most `n` of this thread's most recent groups are pending,
// n in [0, kMaxPending].
__device__ __forceinline__ void cp_async_wait_pending(const int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<kMaxPending>(); break;
  }
}

// Starts the copies of level k of this thread's column into `slot`, whose
// value j of this thread lies at slot[j * tile].
template <typename T>
__device__ __forceinline__ void stage(const Args<T>& a, T* slot, const int tile,
                                      const int k, const int ncol,
                                      const int nlev, const int64_t col) {
  const int64_t i = int64_t(k) * ncol + col;
  const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
#pragma unroll
  for (int j = 0; j < O::PLU; ++j) {
    cp_async<sizeof(T)>(slot + j * tile, a.in[j] + i);
  }
  cp_async<sizeof(T)>(slot + O::PLU * tile, a.in[O::PLU] + int64_t(k1) * ncol + col);
  cp_async<sizeof(T)>(slot + O::PAPH * tile, a.in[O::PAPH] + i + ncol);
}

template <typename T, bool EVAP>
__global__ void __launch_bounds__(kMaxTile)
    cloudsc2_nl_res_kernel(const __grid_constant__ Args<T> a, const int ncol,
                           const int nlev, const int depth) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  const int tile = blockDim.x;
  const int64_t col = int64_t(blockIdx.x) * tile + threadIdx.x;
  if (col >= ncol) return;
  T* const ring = reinterpret_cast<T*>(ring_bytes) + threadIdx.x;
  const int slot_stride = kStaged * tile;

  // depth <= nlev: the launcher clamps it
  for (int k = 0; k < depth; ++k) {
    stage(a, ring + k * slot_stride, tile, k, ncol, nlev, col);
    cp_async_commit();
  }
  const T* c = a.c;
  const T ptsphy = c[C_PTSPHY];
  const T rtt = c[C_RTT];
  const T rg = c[C_RG];
  const T ztrpaus = __ldg(a.in[O::ZTRPAUS] + col);
  const T paph_sfc = __ldg(a.in[O::PAPH_SFC] + col);
  T zrfl = T(0.0), zsfl = T(0.0), zcovptot = T(0.0);
  T paph_lo = __ldg(a.in[O::PAPH] + col);

  const bool resident = depth >= nlev;
  const int pending = depth - 1 < kMaxPending ? depth - 1 : kMaxPending;
  if (resident) cp_async_wait<0>();
  int s = 0;
  for (int k = 0; k < nlev; ++k) {
    if (!resident) cp_async_wait_pending(pending);
    T* const slot = ring + s * slot_stride;
    T x[N_VALUE];
#pragma unroll
    for (int j = 0; j < O::PLU; ++j) x[j] = slot[j * tile];
    x[X_PLU_K1] = slot[O::PLU * tile];
    x[X_PAPH_LO] = paph_lo;
    x[X_PAPH_HI] = slot[O::PAPH * tile];

    T y[N_OUTPUT];
    level<T, EVAP>(c, x, __ldg(a.in[O::CETA] + k), __ldg(a.in[O::ZSCALM] + k),
                   k < nlev - 1, ptsphy, rtt, rg, ztrpaus, paph_sfc, zrfl, zsfl,
                   zcovptot, y);
    const int64_t i = int64_t(k) * ncol + col;
#pragma unroll
    for (int j = 0; j < N_OUTPUT; ++j) a.out[j][i] = y[j];
    paph_lo = x[X_PAPH_HI];

    if (!resident) {
      // the slot's values are in registers and consumed: refill it.  One
      // group per level, empty past the last one, keeps the count uniform.
      if (k + depth < nlev) stage(a, slot, tile, k + depth, ncol, nlev, col);
      cp_async_commit();
    }
    s = s + 1 == depth ? 0 : s + 1;
  }
}

template <typename T, bool EVAP>
int launch_variant(const Args<T>& a, int ncol, int nlev, int tile, int depth,
                   cudaStream_t s) {
  const size_t ring = size_t(kStaged) * sizeof(T) * tile * depth;
  auto kernel = cloudsc2_nl_res_kernel<T, EVAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(ring));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit it
    return int(err);
  }
  kernel<<<blocks_for(ncol, tile), tile, ring, s>>>(a, ncol, nlev, depth);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const double* consts,
           int ncol, int nlev, int evap, int tile, int depth, void* stream) {
  if (ncol <= 0 || nlev <= 0 || tile <= 0 || tile > kMaxTile || depth <= 0) {
    return int(cudaErrorInvalidValue);
  }
  Args<T> a = {};
  for (int j = 0; j < O::N; ++j) a.in[j] = static_cast<const T*>(in[j]);
  fill_outputs(a, out, consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth > nlev) depth = nlev;
  return evap ? launch_variant<T, true>(a, ncol, nlev, tile, depth, s)
              : launch_variant<T, false>(a, ncol, nlev, tile, depth, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, constants),
// the streams staged per level and the largest block, so the caller can
// check that it was built against the same layout and size the ring.
int cloudsc2_nl_res_abi(int* counts) {
  counts[0] = O::N;
  counts[1] = N_OUTPUT;
  counts[2] = N_CONST;
  counts[3] = kStaged;
  counts[4] = kMaxTile;
  return 0;
}

// Writes the dynamic shared memory, in bytes, that a block may opt into on
// the current device; returns a cudaError_t.
int cloudsc2_nl_res_max_ring_bytes(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  return int(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launches the sweep on `stream` with blocks of `tile` columns and a ring of
// min(depth, nlev) levels, and returns the cudaError_t of the launch.  `in`
// holds O::N device pointers (pt pq pqs pap ... plu paph ceta zscalm ztrpaus
// paph_sfc), `out` N_OUTPUT, `consts` N_CONST host doubles; every level
// array is (nlev, ncol) and paph (nlev+1, ncol).
int cloudsc2_nl_res_f32(const void* const* in, void* const* out,
                        const double* consts, int ncol, int nlev, int evap,
                        int tile, int depth, void* stream) {
  return launch<float>(in, out, consts, ncol, nlev, evap, tile, depth, stream);
}

int cloudsc2_nl_res_f64(const void* const* in, void* const* out,
                        const double* consts, int ncol, int nlev, int evap,
                        int tile, int depth, void* stream) {
  return launch<double>(in, out, consts, ncol, nlev, evap, tile, depth, stream);
}

}  // extern "C"
