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
// What bounds it on this card.  Not bytes: the unit moves ~14 GB against an
// 8.6 GB bound, at ~1.1 TB/s.  Not the L2 either: the checkpoints in flight
// outgrow its 50 MB at any occupancy that keeps the SMs busy.  The two
// bodies are bound by the warps their registers allow, and they want
// different budgets: in their own kernels the TL body runs at 64 registers
// (32 warps per SM), the AD body at 96 (20 warps).  One __launch_bounds__
// gives both the same budget, which is why the roles below set their own.
// Even so the roles share one register file that each body, at its own
// kernel's occupancy, fills alone: on an NVIDIA H100 the best split (12 TL
// and 12 AD warps per SM) takes 12.9 ms at 327,680 f32 columns against
// 11.4 ms for the two-kernel unit; more AD warps starve the TL role or spill
// (probes/fused_grid.py, PERF.md).
//
// Schedule.  A block holds NT TL warpgroups and NA AD warpgroups of 128
// threads (kernels/fused_plan.py chooses them per variant and passes them in
// as -D defines).  Before anything else a TL warpgroup lowers its registers
// to the TL budget (setmaxnreg.dec) and an AD warpgroup raises its own to
// the AD budget (setmaxnreg.inc), from the pool the launch gave the block;
// the roles never meet again in one branch, so ptxas compiles each at its
// own budget.  Work is cut in tiles of 128 columns, one column per thread.
// A TL warpgroup claims a tile from a per-launch counter in device memory
// (one atomicAdd by its first thread: a dynamic scheduler, so the last
// batch of a persistent grid leaves no SM idle), sweeps it ascending with
// cloudsc2_tl::sweep_column, writes its 8 primal and 8 tangent streams, and
// puts its 3 x nlev checkpoints into one of the D slots of its ring in a
// global scratch.  It then arrives on the slot's `full` mbarrier, whose
// release orders those writes before any read by a thread that has waited
// on it (acquire).  The NA/NT AD warpgroups of a ring take its slots in
// turn, sweep the tile descending with cloudsc2_ad::sweep_column (seeds
// from the tangent streams, checkpoints from the slot, both plain loads:
// `__ldg` is undefined on data the running kernel wrote) and arrive on the
// slot's `empty` mbarrier.  The tile index travels in the slot's header.
// A TL warpgroup that finds no tile left puts one end mark in each of its
// consumers' next slots.  With D at least the consumers of a ring, a wait
// on a phase's parity never meets the same parity two phases away.  After
// the roles split no thread waits on barrier 0: the TL warpgroup shares
// the tile index through a named barrier of 128 threads.  The AD body's
// parked values (cloudsc2_ad_level.cuh) take shared memory for the AD
// warpgroups only, indexed by a thread's place among them.
//
// The scratch is blocks x NT x D slots of 3 x nlev x 128 values, sized by
// the grid and not by ncol; results per column do not depend on which block
// swept the tile.  The wrapper passes a counter that this launcher zeroes on
// the stream before every launch.  Built with nvcc for sm_90a (setmaxnreg
// exists for that target only) by cloudsc2jax_torch/kernels/build.py,
// without fast math.

#include "cloudsc2_ad_sweep.cuh"
#include "cloudsc2_tl_sweep.cuh"

#if !defined(CLOUDSC2_FUSED_F32_E0_R0_NT) || !defined(CLOUDSC2_FUSED_F32_E0_R1_NT) || \
    !defined(CLOUDSC2_FUSED_F32_E1_R0_NT) || !defined(CLOUDSC2_FUSED_F32_E1_R1_NT) || \
    !defined(CLOUDSC2_FUSED_F64_E0_R0_NT) || !defined(CLOUDSC2_FUSED_F64_E0_R1_NT) || \
    !defined(CLOUDSC2_FUSED_F64_E1_R0_NT) || !defined(CLOUDSC2_FUSED_F64_E1_R1_NT)
#error "build with the splits of kernels/fused_plan.py (build.py passes them)"
#endif

namespace {

namespace tl = cloudsc2_tl;
namespace ad = cloudsc2_ad;

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

constexpr int kGroup = 128;  // threads of a warpgroup, columns of a tile
static_assert(kGroup == kStashStride, "a warpgroup owns one stash group");

// One variant's split (fused_plan.Split; its fields are -D defines of
// their own, fused_plan.FIELDS).
struct Split {
  int tl_groups, ad_groups, blocks, tl_registers, ad_registers, depth;
};

template <typename T, bool EVAP, bool LREGCL>
struct SplitOf;
#define CLOUDSC2_FUSED_SPLIT(T, EVAP, LREGCL, P)                          \
  template <>                                                             \
  struct SplitOf<T, EVAP, LREGCL> {                                       \
    static constexpr Split value = {P##_NT, P##_NA, P##_BLOCKS, P##_TL,   \
                                    P##_AD, P##_DEPTH};                   \
  };
CLOUDSC2_FUSED_SPLIT(float, false, false, CLOUDSC2_FUSED_F32_E0_R0)
CLOUDSC2_FUSED_SPLIT(float, false, true, CLOUDSC2_FUSED_F32_E0_R1)
CLOUDSC2_FUSED_SPLIT(float, true, false, CLOUDSC2_FUSED_F32_E1_R0)
CLOUDSC2_FUSED_SPLIT(float, true, true, CLOUDSC2_FUSED_F32_E1_R1)
CLOUDSC2_FUSED_SPLIT(double, false, false, CLOUDSC2_FUSED_F64_E0_R0)
CLOUDSC2_FUSED_SPLIT(double, false, true, CLOUDSC2_FUSED_F64_E0_R1)
CLOUDSC2_FUSED_SPLIT(double, true, false, CLOUDSC2_FUSED_F64_E1_R0)
CLOUDSC2_FUSED_SPLIT(double, true, true, CLOUDSC2_FUSED_F64_E1_R1)
#undef CLOUDSC2_FUSED_SPLIT

// A ring slot's header in shared memory.
struct SlotHeader {
  unsigned long long full;   // mbarrier: the TL warpgroup's 128 arrivals
  unsigned long long empty;  // mbarrier: the AD warpgroup's 128 arrivals
  int tile;                  // the tile in the slot, -1 the end mark
  int pad;
};
static_assert(sizeof(SlotHeader) == 24, "fused_plan.SLOT_HEADER_BYTES");

// The compile-time shape of a variant, with the rules fused_plan.check
// holds in Python.
template <typename T, bool EVAP, bool LREGCL>
struct Plan {
  static constexpr Split s = SplitOf<T, EVAP, LREGCL>::value;
  static constexpr int kTlGroups = s.tl_groups;
  static constexpr int kAdGroups = s.ad_groups;
  static constexpr int kBlocks = s.blocks;
  static constexpr int kTlRegisters = s.tl_registers;
  static constexpr int kAdRegisters = s.ad_registers;
  static constexpr int kDepth = s.depth;
  static constexpr int kThreads = kGroup * (kTlGroups + kAdGroups);
  static constexpr int kConsumers = kAdGroups / kTlGroups;
  static constexpr int kLaunchRegisters =
      (65536 / (kThreads * kBlocks) < 255 ? 65536 / (kThreads * kBlocks) : 255) /
      8 * 8;
  static constexpr size_t kStashBytes =
      ad::stash_bytes<T, EVAP, LREGCL>(kGroup * kAdGroups);
  static constexpr size_t kSharedBytes =
      kStashBytes + size_t(kTlGroups) * kDepth * sizeof(SlotHeader);

  static_assert(kTlGroups >= 1 && kAdGroups >= 1 && kBlocks >= 1, "counts");
  static_assert(kThreads <= 1024, "threads per block");
  static_assert(kTlGroups + 1 <= 16, "one named barrier per TL warpgroup");
  static_assert(kAdGroups % kTlGroups == 0, "AD warpgroups per ring");
  static_assert(kDepth >= kConsumers, "a ring at least as deep as its consumers");
  static_assert(kTlRegisters % 8 == 0 && kTlRegisters >= 24 &&
                    kTlRegisters <= 256 && kAdRegisters % 8 == 0 &&
                    kAdRegisters >= 24 && kAdRegisters <= 256,
                "setmaxnreg takes a multiple of 8 in [24, 256]");
  static_assert(kTlRegisters <= kLaunchRegisters &&
                    kAdRegisters >= kLaunchRegisters,
                "dec lowers and inc raises the launch count");
  static_assert(kTlGroups * kTlRegisters + kAdGroups * kAdRegisters <=
                    (kTlGroups + kAdGroups) * kLaunchRegisters,
                "the roles fit the block's register pool");
  static_assert(kSharedBytes % 8 == 0 && kStashBytes % 16 == 0, "alignment");
  static_assert(kSharedBytes <= 232448, "shared memory per block");
  static_assert(kBlocks * (kSharedBytes + 1024) <= 233472,
                "shared memory per SM");
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar,
                                             const unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(count)
               : "memory");
}

// Arrive with release semantics at block scope (the default of arrive).
__device__ __forceinline__ void barrier_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          shared_address(bar))
      : "memory");
}

// Wait until the phase of parity `parity` has completed, with acquire
// semantics at block scope (the default of try_wait).
__device__ __forceinline__ void barrier_wait(unsigned long long* bar,
                                             const unsigned parity) {
  const unsigned address = shared_address(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(address), "r"(parity)
        : "memory");
  } while (!done);
}

// The 128 threads of one warpgroup, on named barrier `id` (never 0).
__device__ __forceinline__ void group_sync(const int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kGroup) : "memory");
}

template <typename T>
struct Args {
  tl::Args<T> tl;
  ad::Args<T> ad;
};

// A TL warpgroup: claim a tile, sweep it into the next slot of its ring,
// hand it on; at the end, one end mark per consumer.  `slot0` is the value
// offset of the ring's first slot in each checkpoint plane.
template <typename T, bool EVAP, bool LREGCL, int CONSUMERS, int DEPTH>
__device__ __forceinline__ void tl_role(const tl::Args<T>& a, const int ncol,
                                        const int nlev, int* const next_tile,
                                        SlotHeader* const ring,
                                        const int64_t slot0,
                                        const int64_t slot_values,
                                        const int lane, const int barrier_id) {
  const int tiles = (ncol + kGroup - 1) / kGroup;
  int marks = CONSUMERS;  // end marks still to hand on
  for (int n = 0; marks > 0; ++n) {
    const int s = n % DEPTH;
    barrier_wait(&ring[s].empty, ((n / DEPTH) & 1) ^ 1);
    volatile int* const tile_of = &ring[s].tile;
    if (lane == 0) {
      int t = -1;
      if (marks == CONSUMERS) {
        t = atomicAdd(next_tile, 1);
        if (t >= tiles) t = -1;
      }
      *tile_of = t;
    }
    group_sync(barrier_id);
    const int t = *tile_of;
    if (t < 0) {
      --marks;
    } else {
      const int64_t col = int64_t(t) * kGroup + lane;
      if (col < ncol) {
        tl::sweep_column<T, EVAP, LREGCL, true, false, cloudsc2_load::Exact>(
            a, ncol, nlev, col, kGroup, slot0 + s * slot_values + lane);
      }
    }
    barrier_arrive(&ring[s].full);
  }
}

// An AD warpgroup, the `consumer`-th of its ring: every CONSUMERS-th slot
// from its own, until its end mark.
template <typename T, bool EVAP, bool LREGCL, int CONSUMERS, int DEPTH>
__device__ __forceinline__ void ad_role(const ad::Args<T>& a, const int ncol,
                                        const int nlev, SlotHeader* const ring,
                                        const int64_t slot0,
                                        const int64_t slot_values,
                                        const int lane, const int consumer,
                                        T* const stash) {
  for (int n = consumer;; n += CONSUMERS) {
    const int s = n % DEPTH;
    barrier_wait(&ring[s].full, (n / DEPTH) & 1);
    const int t = *static_cast<volatile int*>(&ring[s].tile);
    if (t >= 0) {
      const int64_t col = int64_t(t) * kGroup + lane;
      if (col < ncol) {
        ad::sweep_column<T, EVAP, LREGCL, cloudsc2_load::Exact, true>(
            a, ncol, nlev, col, kGroup, slot0 + s * slot_values + lane, stash);
      }
    }
    barrier_arrive(&ring[s].empty);
    if (t < 0) return;
  }
}

template <typename T, bool EVAP, bool LREGCL>
__global__ void __launch_bounds__(Plan<T, EVAP, LREGCL>::kThreads,
                                  Plan<T, EVAP, LREGCL>::kBlocks)
    cloudsc2_tlad_fused_kernel(const __grid_constant__ Args<T> a,
                               const int ncol, const int nlev,
                               int* const next_tile) {
  using P = Plan<T, EVAP, LREGCL>;
  extern __shared__ __align__(16) unsigned char smem[];
  SlotHeader* const rings = reinterpret_cast<SlotHeader*>(smem + P::kStashBytes);
  if (threadIdx.x == 0) {
    for (int j = 0; j < P::kTlGroups * P::kDepth; ++j) {
      barrier_init(&rings[j].full, kGroup);
      barrier_init(&rings[j].empty, kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles split below
  // uniform per warp, so setmaxnreg runs converged
  const int group = __shfl_sync(0xffffffffu, int(threadIdx.x) / kGroup, 0);
  const int lane = int(threadIdx.x) % kGroup;
  const int64_t slot_values = int64_t(3) * nlev * kGroup;
  if (group < P::kTlGroups) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::kTlRegisters));
    const int64_t slot0 =
        (int64_t(blockIdx.x) * P::kTlGroups + group) * P::kDepth * slot_values;
    tl_role<T, EVAP, LREGCL, P::kConsumers, P::kDepth>(
        a.tl, ncol, nlev, next_tile, rings + group * P::kDepth, slot0,
        slot_values, lane, 1 + group);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kAdRegisters));
    const int g = group - P::kTlGroups;  // place among the AD warpgroups
    const int ring = g % P::kTlGroups;
    const int64_t slot0 =
        (int64_t(blockIdx.x) * P::kTlGroups + ring) * P::kDepth * slot_values;
    ad_role<T, EVAP, LREGCL, P::kConsumers, P::kDepth>(
        a.ad, ncol, nlev, rings + ring * P::kDepth, slot0, slot_values, lane,
        g / P::kTlGroups,
        ad::stash_at<T, EVAP, LREGCL>(smem, int(threadIdx.x) - P::kTlGroups * kGroup));
  }
}

// The variant's split as the library was built, and the registers ptxas
// gave its kernel: tl_groups, ad_groups, blocks per SM, TL budget, AD
// budget, depth, launch registers, shared bytes, registers of the kernel.
template <typename T, bool EVAP, bool LREGCL>
int plan_variant(int* out) {
  using P = Plan<T, EVAP, LREGCL>;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, cloudsc2_tlad_fused_kernel<T, EVAP, LREGCL>);
  if (err != cudaSuccess) return int(err);
  const int values[9] = {P::kTlGroups, P::kAdGroups, P::kBlocks,
                         P::kTlRegisters, P::kAdRegisters, P::kDepth,
                         P::kLaunchRegisters, int(P::kSharedBytes),
                         attr.numRegs};
  for (int j = 0; j < 9; ++j) out[j] = values[j];
  return 0;
}

template <typename T, bool EVAP, bool LREGCL>
int launch_variant(Args<T>& a, const double* params, int ncol, int nlev,
                   int* next_tile, int blocks, cudaStream_t s) {
  using P = Plan<T, EVAP, LREGCL>;
  tl::fill_constants<T, EVAP, LREGCL>(a.tl, params);
  ad::fill_constants<T, EVAP, LREGCL>(a.ad, params);
  auto kernel = cloudsc2_tlad_fused_kernel<T, EVAP, LREGCL>;
  // The roles' budgets must fit the registers the block is given, or an
  // inc would wait for ever: refuse the launch instead.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  const int given = (attr.numRegs + 7) / 8 * 8;
  if (P::kTlRegisters > given || P::kAdRegisters < given ||
      P::kTlGroups * P::kTlRegisters + P::kAdGroups * P::kAdRegisters >
          (P::kTlGroups + P::kAdGroups) * given) {
    return int(cudaErrorInvalidConfiguration);
  }
  const int shared_err = ad::allow_shared(kernel, P::kSharedBytes);
  if (shared_err != 0) return shared_err;
  err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess) return int(err);
  kernel<<<unsigned(blocks), P::kThreads, P::kSharedBytes, s>>>(a, ncol, nlev,
                                                                next_tile);
  return int(cudaGetLastError());
}

template <typename T>
int plan(int evap, int lregcl, int* out) {
  if (evap) {
    return lregcl ? plan_variant<T, true, true>(out)
                  : plan_variant<T, true, false>(out);
  }
  return lregcl ? plan_variant<T, false, true>(out)
                : plan_variant<T, false, false>(out);
}

// `scratch` holds blocks x NT x D slots of 3 x nlev x 128 values; slot
// plane j of checkpoint j starts j x nlev x 128 values into a slot.
template <typename T>
int launch(const void* const* in, void* const* out, const double* params,
           void* scratch, void* next_tile, int blocks, double dscale,
           double seed_rfl, double seed_sfl, int ncol, int nlev, int evap,
           int lregcl, void* stream) {
  if (ncol <= 0 || nlev <= 0 || blocks <= 0 || scratch == nullptr ||
      next_tile == nullptr) {
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
    a.tl.out[tl::O_CKPT + j] = planes + int64_t(j) * nlev * kGroup;
    a.ad.in[ad::S_CKPT + j] = a.tl.out[tl::O_CKPT + j];
  }
  for (int j = 0; j < ad::N_OUTPUT; ++j) {
    a.ad.out[j] = static_cast<T*>(out[O_ADJOINT + j]);
  }
  a.tl.dscale = T(dscale);
  a.ad.seed_rfl = T(seed_rfl);
  a.ad.seed_sfl = T(seed_sfl);
  int* counter = static_cast<int*>(next_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (evap) {
    return lregcl ? launch_variant<T, true, true>(a, params, ncol, nlev, counter, blocks, s)
                  : launch_variant<T, true, false>(a, params, ncol, nlev, counter, blocks, s);
  }
  return lregcl ? launch_variant<T, false, true>(a, params, ncol, nlev, counter, blocks, s)
                : launch_variant<T, false, false>(a, params, ncol, nlev, counter, blocks, s);
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

// The split of one variant as built, into `out` (9 ints, plan_variant's
// order).  Returns a cudaError_t.
int cloudsc2_tlad_fused_plan(int is_double, int evap, int lregcl, int* out) {
  return is_double ? plan<double>(evap, lregcl, out)
                   : plan<float>(evap, lregcl, out);
}

// Launches the unit on `stream` with `blocks` blocks and returns the
// cudaError_t of the launch (cudaErrorInvalidConfiguration where the
// roles' budgets do not fit the registers ptxas gave the kernel).  `in`
// holds N_STREAM device pointers (the TL sweep's), `out` N_OUTPUT,
// `scratch` blocks x NT x D x 3 x nlev x 128 values, `next_tile` one int
// (zeroed here on the stream), `params` kNumParams host doubles; every level
// array is (nlev, ncol), paph and d_paph (nlev+1, ncol).
int cloudsc2_tlad_fused_f32(const void* const* in, void* const* out,
                            const double* params, void* scratch,
                            void* next_tile, int blocks, double dscale,
                            double seed_rfl, double seed_sfl, int ncol,
                            int nlev, int evap, int lregcl, void* stream) {
  return launch<float>(in, out, params, scratch, next_tile, blocks, dscale,
                       seed_rfl, seed_sfl, ncol, nlev, evap, lregcl, stream);
}

int cloudsc2_tlad_fused_f64(const void* const* in, void* const* out,
                            const double* params, void* scratch,
                            void* next_tile, int blocks, double dscale,
                            double seed_rfl, double seed_sfl, int ncol,
                            int nlev, int evap, int lregcl, void* stream) {
  return launch<double>(in, out, params, scratch, next_tile, blocks, dscale,
                        seed_rfl, seed_sfl, ncol, nlev, evap, lregcl, stream);
}

}  // extern "C"
