// The TL+AD work unit in ONE launch: the tangent-linear sweep ascending,
// then the reverse-adjoint sweep descending, per column, with the carry
// checkpoints between them never written as (nlev, ncol) streams.
//
// Replaces the TPU kernel `_fused_tlad_kernel`
// (cloudsc2jax/pallas/experiments.py:286) as `cloudsc2_pallas_tlad_fused`
// (:398) runs it.  What it computes is the two-kernel unit's contract
// (cloudsc2_tl.cu with `dscale` and primal streams, then cloudsc2_ad.cu with
// the TL image as seeds, the flux seeds folded): 8 primal and 8 tangent
// streams written once, and the levels-major adjoints of the 16 inputs with
// d_plu and d_paph already scattered by the thread that owns the column
// (the TPU version emitted 17 shifted-view streams and assembled them
// afterwards, experiments.py:478-495).
//
// Schedule.  The TPU grid ran (column block, 2*nlev) in order and kept the
// 3*nlev checkpoints and 8*nlev tangent seeds of a block in 49 MB of VMEM.
// Nothing of that size exists per SM here (227 KB of shared memory holds
// the checkpoints of 128 columns and no more), so the cross-phase values go
// through global memory, but through a scratch sized by the launch's
// RESIDENT THREADS and not by ncol: the grid is persistent (SMs x blocks
// per SM, from the occupancy calculator), each thread strides over columns
// slot, slot + slots, ..., and checkpoint j of level k lives at
// scratch[j][k][slot], so a warp's access is one coalesced segment.  With
// 132 SMs x 4 blocks x 128 threads that is 67,584 slots, 111 MB in f32 at
// 137 levels: twice the L2's 50 MB, rewritten batch after batch, where the
// two-kernel unit writes and re-reads 3 streams of ncol columns through
// device memory.  The tangent seeds are re-read from the dout rows the same
// thread wrote a moment ago (8 more reads than the TPU kernel, which kept
// them on chip too).  Both are plain loads: `__ldg` is undefined on data
// the running kernel wrote.  (Keeping the seeds in 8 more scratch planes, the
// TPU kernel's layout, was measured and lost: PERF.md.)
//
// A thread runs `cloudsc2_tl::sweep_column` and then
// `cloudsc2_ad::sweep_column` for each of its columns, the very loops of
// the two-kernel unit; every carry is initialised inside them, per column.
// The price is registers: one budget serves both bodies, and the AD body
// wants more than the TL body (168 against 128 in f32 in their own kernels;
// 255 with spills in f64).  Measured on an NVIDIA H100 at 327,680 f32
// columns, 4 blocks of 128 threads per SM (128 registers, 188 B of spill
// stores, 16 warps) beat 3 blocks (168 registers, no spills, 12 warps) by
// 9-12%, so the f32 kernels are bounded to 4: both phases then run at the TL
// kernel's occupancy.  The persistent grid has a tail, the last batch of
// columns filling only part of the slots (4.85 batches at that size).
// PERF.md holds the block-size table.
//
// Bytes per level and column, f32: 16 input streams read twice (128 B), 8
// seeds read back (32 B), 32 streams written (128 B); the two-kernel unit
// moves 312 B.  Built with nvcc for sm_90a by
// cloudsc2jax_torch/kernels/build.py, without fast math.
// CLOUDSC2_FUSED_THREADS and CLOUDSC2_FUSED_MIN_BLOCKS_F32 (-D) set the
// block size and the blocks per SM the f32 register budget must allow; only
// probes/fused_grid.py, which measures that table, sets them.

#include "cloudsc2_ad_sweep.cuh"
#include "cloudsc2_tl_sweep.cuh"

#ifndef CLOUDSC2_FUSED_THREADS
#define CLOUDSC2_FUSED_THREADS 128
#endif
#ifndef CLOUDSC2_FUSED_MIN_BLOCKS_F32
#define CLOUDSC2_FUSED_MIN_BLOCKS_F32 4
#endif

namespace {

namespace tl = cloudsc2_tl;
namespace ad = cloudsc2_ad;

constexpr int kThreads = CLOUDSC2_FUSED_THREADS;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? CLOUDSC2_FUSED_MIN_BLOCKS_F32 : 1;

constexpr bool same_text(const char* a, const char* b) {
  for (; *a == *b; ++a, ++b) {
    if (*a == '\0') return true;
  }
  return false;
}
// one params array feeds both level bodies
static_assert(tl::kNumParams == ad::kNumParams &&
                  same_text(tl::kParamNames, ad::kParamNames),
              "the TL and AD level bodies take different params");
// and one array of input pointers both sweeps
static_assert(int(tl::N_STREAM) == int(ad::S_CKPT) &&
                  int(tl::S_PAPH_SFC) == int(ad::S_PAPH_SFC),
              "the TL and AD sweeps order their input streams differently");

// Pointer order of the launcher's `out` (FUSED_OUTPUTS in
// kernels/experiments.py): 8 primal streams, 8 tangent streams, then the 16
// input adjoints in cloudsc2_ad's order.
enum Output { O_PRIMAL = 0, O_TANGENT = 8, O_ADJOINT = 16, N_OUTPUT = 32 };

template <typename T>
struct Args {
  tl::Args<T> tl;
  ad::Args<T> ad;
};

template <typename T, bool EVAP, bool LREGCL>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    cloudsc2_tlad_fused_kernel(const __grid_constant__ Args<T> a,
                               const int ncol, const int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];  // the AD body's slots
  T* const stash = ad::stash_of<T, EVAP, LREGCL>(smem);
  const int64_t slots = int64_t(gridDim.x) * kThreads;
  const int64_t slot = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t col = slot; col < ncol; col += slots) {
    tl::sweep_column<T, EVAP, LREGCL, true, false, cloudsc2_load::Exact>(
        a.tl, ncol, nlev, col, slots, slot);
    ad::sweep_column<T, EVAP, LREGCL, cloudsc2_load::Exact, true>(
        a.ad, ncol, nlev, col, slots, slot, stash);
  }
}

// Bytes of shared memory a block of the fused kernel takes.
template <typename T, bool EVAP, bool LREGCL>
constexpr size_t kSharedBytes = ad::stash_bytes<T, EVAP, LREGCL>(kThreads);

template <typename T, bool EVAP, bool LREGCL>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   int slots, cudaStream_t s) {
  tl::fill_constants<T, EVAP, LREGCL>(a.tl, params);
  ad::fill_constants<T, EVAP, LREGCL>(a.ad, params);
  auto kernel = cloudsc2_tlad_fused_kernel<T, EVAP, LREGCL>;
  constexpr size_t bytes = kSharedBytes<T, EVAP, LREGCL>;
  const int err = ad::allow_shared(kernel, bytes);
  if (err != 0) return err;
  kernel<<<unsigned(slots / kThreads), kThreads, bytes, s>>>(a, ncol, nlev);
  return int(cudaGetLastError());
}

template <typename T, bool EVAP, bool LREGCL>
int blocks_per_sm(int* blocks) {
  auto kernel = cloudsc2_tlad_fused_kernel<T, EVAP, LREGCL>;
  constexpr size_t bytes = kSharedBytes<T, EVAP, LREGCL>;
  const int err = ad::allow_shared(kernel, bytes);
  if (err != 0) return err;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kThreads, bytes));
}

template <typename T>
int resident(int evap, int lregcl, int* blocks) {
  if (evap) {
    return lregcl ? blocks_per_sm<T, true, true>(blocks)
                  : blocks_per_sm<T, true, false>(blocks);
  }
  return lregcl ? blocks_per_sm<T, false, true>(blocks)
                : blocks_per_sm<T, false, false>(blocks);
}

// `scratch` is (3, nlev, slots), one plane per checkpoint.  Any
// multiple of the block size is a valid `slots`: it is the grid's thread
// count, and a grid larger than the card holds at once is still right, only
// not persistent.
template <typename T>
int launch(const void* const* in, void* const* out, const double* params,
           void* scratch, int slots, double dscale, double seed_rfl,
           double seed_sfl, int ncol, int nlev, int evap, int lregcl,
           void* stream) {
  if (ncol <= 0 || nlev <= 0 || slots <= 0 || slots % kThreads != 0 ||
      scratch == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  for (int j = 0; j < N_OUTPUT; ++j) {
    if (out[j] == nullptr) return int(cudaErrorInvalidValue);
  }
  Args<T> a = {};
  T* planes = static_cast<T*>(scratch);
  for (int j = 0; j < tl::N_STREAM; ++j) {
    a.tl.in[j] = a.ad.in[j] = static_cast<const T*>(in[j]);
  }
  for (int j = 0; j < 8; ++j) {
    a.tl.out[tl::O_PRIMAL + j] = static_cast<T*>(out[O_PRIMAL + j]);
    a.tl.out[tl::O_TANGENT + j] = static_cast<T*>(out[O_TANGENT + j]);
    a.ad.in[ad::S_SEED + j] = static_cast<const T*>(out[O_TANGENT + j]);
  }
  for (int j = 0; j < 3; ++j) {
    a.tl.out[tl::O_CKPT + j] = planes + int64_t(j) * nlev * slots;
    a.ad.in[ad::S_CKPT + j] = a.tl.out[tl::O_CKPT + j];
  }
  for (int j = 0; j < ad::N_OUTPUT; ++j) {
    a.ad.out[j] = static_cast<T*>(out[O_ADJOINT + j]);
  }
  a.tl.dscale = T(dscale);
  a.ad.seed_rfl = T(seed_rfl);
  a.ad.seed_sfl = T(seed_sfl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_variant<T, true, true>(a, params, ncol, nlev, slots, s)
                  : launch_variant<T, true, false>(a, params, ncol, nlev, slots, s);
  }
  return lregcl ? launch_variant<T, false, true>(a, params, ncol, nlev, slots, s)
                : launch_variant<T, false, false>(a, params, ncol, nlev, slots, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the argument arrays (streams, outputs, params), so
// the caller can check that it was built against the same layout.
int cloudsc2_tlad_fused_abi(int* counts) {
  counts[0] = tl::N_STREAM;
  counts[1] = N_OUTPUT;
  counts[2] = tl::kNumParams;
  return 0;
}

// The params `params` holds, in order, space-separated ("yomcst.rg ...").
const char* cloudsc2_tlad_fused_param_names() { return tl::kParamNames; }

// What sizes the persistent grid and its scratch on the current device: the
// block size, the blocks of this variant that one SM holds at once, and the
// SM count.  Returns a cudaError_t.
int cloudsc2_tlad_fused_resident(int is_double, int evap, int lregcl,
                                 int* threads, int* blocks, int* sms) {
  *threads = kThreads;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  return is_double ? resident<double>(evap, lregcl, blocks)
                   : resident<float>(evap, lregcl, blocks);
}

// Launches the unit on `stream` with a grid of `slots` threads and returns
// the cudaError_t of the launch.  `in` holds N_STREAM device pointers (the
// TL sweep's), `out` N_OUTPUT, `scratch` 3 * nlev * slots values, `params`
// kNumParams host doubles; every level array is (nlev, ncol), paph and
// d_paph (nlev+1, ncol).
int cloudsc2_tlad_fused_f32(const void* const* in, void* const* out,
                            const double* params, void* scratch, int slots,
                            double dscale, double seed_rfl, double seed_sfl,
                            int ncol, int nlev, int evap, int lregcl,
                            void* stream) {
  return launch<float>(in, out, params, scratch, slots, dscale, seed_rfl,
                       seed_sfl, ncol, nlev, evap, lregcl, stream);
}

int cloudsc2_tlad_fused_f64(const void* const* in, void* const* out,
                            const double* params, void* scratch, int slots,
                            double dscale, double seed_rfl, double seed_sfl,
                            int ncol, int nlev, int evap, int lregcl,
                            void* stream) {
  return launch<double>(in, out, params, scratch, slots, dscale, seed_rfl,
                        seed_sfl, ncol, nlev, evap, lregcl, stream);
}

}  // extern "C"
