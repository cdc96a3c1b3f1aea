// CLOUDSC2 nonlinear sweep: one thread owns one column.  Two kernels share
// the hand-written level body below.
//
// `cloudsc2_nl_kernel` replaces the TPU kernel `_stream_kernel`
// (cloudsc2jax/pallas/cloudsc2_kernel.py:348) run with fuse_satur=True, whose
// level body is `_level_physics` (:78-345).  qsat is SATUR of pt and pap,
// computed in registers; no pqs stream is read.
//
// `cloudsc2_fwd_ckpt_kernel` replaces the TPU kernel `_fwd_ckpt_kernel`
// (cloudsc2jax/pallas/tlad_kernel.py:405), the forward sweep of the
// standalone adjoint: the same level body with pqs READ as a 16th stream
// (pqs is one of the differentiated inputs, and the reverse sweep recomputes
// each level from the streamed value, so the checkpoints must come from that
// trajectory and not from SATUR of pt and pap), and with the carry going
// INTO each level (rfl, sfl, covptot) written as 3 checkpoint streams.
//
// The arithmetic below follows `_level_physics` line by line, with the same
// association and the same strict or non-strict comparisons; constants that
// Python folds in double before they meet an array (zcons2, zckcodtl,
// 1.9*rclcrit, rcpd*rvtmp2, ...) arrive folded from the host in `Args::c`
// and are rounded to T once.
//
// Schedule.  On the TPU the grid ran (column block, level) in order and
// carried rfl/sfl/covptot in VMEM scratch from one level step to the next.
// Here blocks run in no order, so each thread loops over the 137 levels of
// its own column with the carry in registers.  The arrays are levels-major
// (nlev, ncol) with no column padding: a level read by a warp is one
// coalesced row segment, and the ragged last block masks its tail.
// paph(k+1) of step k is kept as paph(k) of step k+1, so each of the 15
// input streams is read once per level; plu(k+1) is clamped at the last
// level as in `_level_index_maps` (:522-536).
//
// What bounds it on this card: device-memory bytes.  Per level and column
// the sweep reads 15 values and writes 8 (92 bytes in f32; the checkpointing
// sweep 16 and 11, 108 bytes) for about 300 flops and 12 transcendentals,
// far below the H100's flop/byte balance.  Measured on an NVIDIA H100 (700
// W) at 327,680 f32 columns: 1.73 ms (NL) and 2.19-2.23 ms (checkpointing)
// against bytes bounds of 1.23 and 1.45 ms (PERF.md).
// The design therefore moves each byte once: no relayout before or after,
// one read per stream, no intermediate written back, the carry in
// registers.  Overlapping loads across levels (prefetch, TMA) is later
// work.
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// --use_fast_math: exp, tanh, sqrt and pow are the IEEE-accurate library
// functions.  FMA contraction is allowed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// Pointer order of Args::in; cloudsc2jax_torch/kernels/cloudsc2_kernel.py
// KERNEL_STREAMS lists the same names in the same order (a test checks).
enum Stream {
  S_PT, S_PQ, S_PAP, S_PL, S_PI, S_PLUDE, S_PMFU, S_PMFD,
  S_TEN_T, S_TEN_Q, S_TEN_L, S_TEN_I, S_PSUPSAT, S_PLU, S_PAPH,
  S_CETA, S_ZSCALM, S_ZTRPAUS, S_PAPH_SFC,
  N_STREAM
};

// Pointer order of Args::out (KERNEL_OUTPUTS).
enum Output {
  O_TENL_T, O_TENL_Q, O_TENL_L, O_TENL_I, O_PCLC, O_PCOVPTOT, O_RFLN,
  O_SFLN,
  N_OUTPUT
};

// Order of Args::c (KERNEL_CONSTANTS).
enum Const {
  C_PTSPHY, C_RG, C_RD, C_RCPD, C_RETV, C_RLVTT, C_RLSTT, C_RLMLT, C_RTT,
  C_RCPD_RVTMP2, C_INV_RCPD, C_ZCONS2, C_ZCONS3, C_ZMELTP2, C_ZQTMST,
  C_ZCKCODTL, C_ZCKCODTI, C_ZLCRIT_L, C_ZLCRIT_I, C_RLMIN, C_RG_RPECONS,
  C_PTSPHY_RG, C_RLPTRC, C_R2ES, C_R3LES, C_R3IES, C_R4LES, C_R4IES,
  C_R5LES, C_R5IES, C_R5ALVCP, C_R5ALSCP, C_RALVDCP, C_RALSDCP, C_RTICE,
  C_RTWAT, C_RTWAT_RTICE_R,
  N_CONST
};

// The checkpointing sweep's argument arrays: the streams above and then
// pqs; the outputs above and then the 3 carry-in checkpoints.
constexpr int kFwdStreams = N_STREAM + 1;
constexpr int kFwdOutputs = N_OUTPUT + 3;

template <typename T>
struct Args {
  const T* in[N_STREAM];
  T* out[N_OUTPUT];
  T c[N_CONST];
  const T* pqs;  // the checkpointing sweep only
  T* ckpt[3];    // the checkpointing sweep only: rfl, sfl, covptot
};

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double xtanh(double x) { return tanh(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) { return pow(x, y); }
template <typename T>
__device__ __forceinline__ T xmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) { return b > a ? b : a; }
template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

// SATUR with LPHYLIN=True, kflag=2 (cloudsc2jax/physics/satur.py:35-41,49).
template <typename T>
__device__ __forceinline__ T satur(const T* c, T pap, T t) {
  const T alfa = xmin(
      T(1.0),
      sq((xmax(c[C_RTICE], xmin(c[C_RTWAT], t)) - c[C_RTICE]) *
         c[C_RTWAT_RTICE_R]));
  const T ew_liq =
      c[C_R2ES] * xexp(c[C_R3LES] * (t - c[C_RTT]) / (t - c[C_R4LES]));
  const T ew_ice =
      c[C_R2ES] * xexp(c[C_R3IES] * (t - c[C_RTT]) / (t - c[C_R4IES]));
  const T ew = alfa * ew_liq + (T(1.0) - alfa) * ew_ice;
  T qs = ew / pap;
  qs = qs > T(0.5) ? T(0.5) : qs;
  return qs / (T(1.0) - c[C_RETV] * qs);
}

// Critical relative humidity (cloudsc2jax/physics/cloudsc2.py:101-126).
template <typename T>
__device__ __forceinline__ T crit_rel_humidity(T ceta_k, T zeta3) {
  const T zrh2 = T(0.35) + T(0.14) * sq((zeta3 - T(0.25)) / T(0.15)) +
                 T(0.04) * xmin(zeta3 - T(0.25), T(0.0)) / T(0.15);
  const T zdeta2 = T(0.3);
  const T zdeta1 = T(0.09) + T(0.16) * (T(0.4) - zeta3) / T(0.3);
  if (ceta_k < zeta3) return T(1.0);
  if (ceta_k < zeta3 + zdeta2)
    return T(1.0) + (zrh2 - T(1.0)) * ((ceta_k - zeta3) / zdeta2);
  if (ceta_k < T(1.0) - zdeta1) return zrh2;
  return T(1.0) +
         (zrh2 - T(1.0)) * xsqrt(xmax((T(1.0) - ceta_k) / zdeta1, T(0.0)));
}

// The sweep of one column.  FWD_CKPT reads pqs and writes the checkpoints.
template <typename T, bool EVAP, bool FWD_CKPT>
__device__ __forceinline__ void sweep(const Args<T>& a, const int ncol,
                                      const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const T* c = a.c;
  const T ptsphy = c[C_PTSPHY];
  const T rtt = c[C_RTT];
  const T rg = c[C_RG];

  const T ztrpaus = __ldg(a.in[S_ZTRPAUS] + col);
  const T paph_sfc = __ldg(a.in[S_PAPH_SFC] + col);
  T zrfl = T(0.0), zsfl = T(0.0), zcovptot = T(0.0);
  T paph_lo = __ldg(a.in[S_PAPH] + col);

  for (int k = 0; k < nlev; ++k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int64_t i1 = int64_t(k + 1 < nlev ? k + 1 : nlev - 1) * ncol + col;
    const T pt = __ldg(a.in[S_PT] + i);
    const T pq = __ldg(a.in[S_PQ] + i);
    const T pap = __ldg(a.in[S_PAP] + i);
    const T pl = __ldg(a.in[S_PL] + i);
    const T pi = __ldg(a.in[S_PI] + i);
    const T plude = __ldg(a.in[S_PLUDE] + i);
    const T pmfu = __ldg(a.in[S_PMFU] + i);
    const T pmfd = __ldg(a.in[S_PMFD] + i);
    const T ten_t = __ldg(a.in[S_TEN_T] + i);
    const T ten_q = __ldg(a.in[S_TEN_Q] + i);
    const T ten_l = __ldg(a.in[S_TEN_L] + i);
    const T ten_i = __ldg(a.in[S_TEN_I] + i);
    const T psupsat = __ldg(a.in[S_PSUPSAT] + i);
    const T plu_k1 = __ldg(a.in[S_PLU] + i1);
    const T paph_hi = __ldg(a.in[S_PAPH] + int64_t(k + 1) * ncol + col);
    const T ceta_k = __ldg(a.in[S_CETA] + k);
    const T zscalm_k = __ldg(a.in[S_ZSCALM] + k);
    const bool not_last = k < nlev - 1;
    const T pqs = FWD_CKPT ? __ldg(a.pqs + i) : satur(c, pap, pt);
    if (FWD_CKPT) {
      a.ckpt[0][i] = zrfl;
      a.ckpt[1][i] = zsfl;
      a.ckpt[2][i] = zcovptot;
    }

    // first-guess state (:253-260) and layer thickness (:272)
    T ztp1 = pt + ptsphy * ten_t;
    T zqp1 = pq + ptsphy * ten_q + psupsat;
    const T zl = pl + ptsphy * ten_l;
    const T zi = pi + ptsphy * ten_i;
    const T zdp = paph_hi - paph_lo;

    // latent-heat factors (:272-277)
    const T zzz = T(1.0) / (c[C_RCPD] + c[C_RCPD_RVTMP2] * zqp1);
    const T zlfdcp = c[C_RLMLT] * zzz;
    const T zlsdcp = c[C_RLSTT] * zzz;
    const T zlvdcp = c[C_RLVTT] * zzz;

    // 3.1 dqs/dT (LPHYLIN branch, :349-364)
    const T zoealfaw =
        T(0.545) * (xtanh(T(0.17) * (ztp1 - c[C_RLPTRC])) + T(1.0));
    const bool cold = ztp1 < rtt;
    const T zfwat = cold ? zoealfaw : T(1.0);
    const T z3es = cold ? c[C_R3IES] : c[C_R3LES];
    const T z4es = cold ? c[C_R4IES] : c[C_R4LES];
    const T zfoeew = c[C_R2ES] * xexp(z3es * (ztp1 - rtt) / (ztp1 - z4es));
    const T zesdp = xmin(zfoeew / pap, T(0.5));
    const T zfacw = c[C_R5LES] / sq(ztp1 - c[C_R4LES]);
    const T zfaci = c[C_R5IES] / sq(ztp1 - c[C_R4IES]);
    const T zfac = zfwat * zfacw + (T(1.0) - zfwat) * zfaci;
    const T zcor = T(1.0) / (T(1.0) - c[C_RETV] * zesdp);
    const T zdqsdtemp = zfac * zcor * pqs;
    const T zcorqs = T(1.0) + c[C_ZCONS3] * zdqsdtemp;
    const T zqlim = zqp1 > pqs ? pqs : zqp1;

    const T zcrh2 = crit_rel_humidity(ceta_k, ztrpaus);
    const T zsupsat_fac =
        ztp1 < c[C_RTICE] ? T(1.8) - T(3.0e-3) * ztp1 : T(1.0);
    const T zqsat = pqs * zsupsat_fac;
    const T zqcrit = zcrh2 * zqsat;

    // cloud cover (:412-427)
    const T zqt = zqp1 + zl + zi;
    const T zqpd = zqsat - zqt;
    const T zqcd = zqsat - zqcrit;
    const bool mid = (zqt > zqcrit) && (zqt < zqsat);
    const bool saturated = zqt >= zqsat;
    T pclc, zqc;
    if (mid) {
      const T denom = zqcd - zscalm_k * (zqt - zqcrit);
      const T ratio = zqpd / denom;
      const T pclc_mid = T(1.0) - xsqrt(xmax(ratio, T(0.0)));
      pclc = pclc_mid;
      zqc = (zscalm_k * zqpd + (T(1.0) - zscalm_k) * zqcd) * sq(pclc_mid);
    } else if (saturated) {
      pclc = T(1.0);
      zqc = (T(1.0) - zscalm_k) * zqcd;
    } else {
      pclc = T(0.0);
      zqc = T(0.0);
    }

    // convective detrainment (:431-444)
    const T zgdp = rg / zdp;
    const T zlude = plude * ptsphy * zgdp;
    const bool llo1 = not_last && (zlude >= c[C_RLMIN]) && (plu_k1 >= T(1.0e-10));
    if (llo1) {
      pclc = pclc + (T(1.0) - pclc) * (T(1.0) - xexp(-zlude / plu_k1));
      zqc = zqc + zlude;
    }

    // compensating subsidence (:448-460)
    const T zrho = pap / (c[C_RD] * ztp1);
    const T zrodqsdp = -zrho * pqs / (pap - c[C_RETV] * zfoeew);
    const T zldcp = zfwat * zlvdcp + (T(1.0) - zfwat) * zlsdcp;
    const T zfac3 = T(1.0) / (T(1.0) + zldcp * zdqsdtemp);
    const T dtdzmo = rg * (c[C_INV_RCPD] - zldcp * zrodqsdp) * zfac3;
    const T zdqsdz = zdqsdtemp * dtdzmo - rg * zrodqsdp;
    const T zdqc_sub = zdqsdz * (pmfu + pmfd) * ptsphy / zrho;
    // MIN tie convention (cloudsc2tl.F90:651-661)
    zqc = zqc - (zdqc_sub < zqc ? zdqc_sub : zqc);

    // condensation rates (:464-469)
    T zqlwc = zqc * zfwat;
    T zqiwc = zqc * (T(1.0) - zfwat);
    T zcondl = (zqlwc - zl) * c[C_ZQTMST];
    T zcondi = (zqiwc - zi) * c[C_ZQTMST];

    // precip overlap (:475-481)
    zcovptot = xmax(zcovptot, pclc);
    const T zcovpclr = xmax(zcovptot - pclc, T(0.0));

    // snow melt (:487-498)
    const T zcons = c[C_ZCONS2] * zdp / zlfdcp;
    const T zsnmlt = xmin(zsfl, zcons * xmax(T(0.0), ztp1 - c[C_ZMELTP2]));
    T zrfln = zrfl + zsnmlt;
    T zsfln = zsfl - zsnmlt;
    ztp1 = ztp1 - zsnmlt / zcons;

    // autoconversion (:504-534)
    const bool active = pclc > T(1.0e-10);
    const T pclc_safe = active ? pclc : T(1.0);
    const T zcldl = zqlwc / pclc_safe;
    const T zdl =
        c[C_ZCKCODTL] * (T(1.0) - xexp(-sq(zcldl / c[C_ZLCRIT_L])));
    const T zlnew = pclc * zcldl * xexp(-zdl);
    const T zprr = active ? zqlwc - zlnew : T(0.0);
    zqlwc = zqlwc - zprr;

    const T zcldi = zqiwc / pclc_safe;
    const T zdi = c[C_ZCKCODTI] * xexp(T(0.025) * (ztp1 - rtt)) *
                  (T(1.0) - xexp(-sq(zcldi / c[C_ZLCRIT_I])));
    const T zinew = pclc * zcldi * xexp(-zdi);
    const T zprs = active ? zqiwc - zinew : T(0.0);
    zqiwc = zqiwc - zprs;

    // freezing split (:538-552)
    const T zdr = c[C_ZCONS2] * zdp * (zprr + zprs);
    const bool cold1 = ztp1 < rtt;
    T zrfreeze = cold1 ? c[C_ZCONS2] * zdp * zprr : T(0.0);
    T zfwatr = cold1 ? T(0.0) : T(1.0);
    zrfln = zrfln + zfwatr * zdr;
    zsfln = zsfln + (T(1.0) - zfwatr) * zdr;

    // clear-sky precip evaporation (:556-591)
    const T zprtot = zrfln + zsfln;
    T pcov = T(0.0), zevapr = T(0.0), zevaps = T(0.0);
    if (EVAP) {
      const bool llo2 = (zprtot > T(1.0e-10)) && (zcovpclr > T(1.0e-10));
      if (llo2) {
        const T zpreclr = zprtot * zcovpclr / zcovptot;
        const T zqe = pqs - (pqs - zqlim) * zcovpclr / sq(T(1.0) - pclc);
        const T zbeta_arg =
            xsqrt(pap / paph_sfc) / T(5.09e-3) * zpreclr / zcovpclr;
        const T zbeta = c[C_RG_RPECONS] * xpow(zbeta_arg, T(0.5777));
        const T zb = ptsphy * zbeta * (pqs - zqe) /
                     (T(1.0) + zbeta * ptsphy * zcorqs);
        const T zdtgdp = c[C_PTSPHY_RG] / zdp;
        const T zdpr = xmin(zcovpclr * zb / zdtgdp, zpreclr);
        const T zpreclr2 = zpreclr - zdpr;
        zcovptot = zpreclr2 <= T(0.0) ? pclc : zcovptot;
        pcov = zcovptot;
        zevapr = zdpr * zrfln / zprtot;
        zevaps = zdpr * zsfln / zprtot;
        zrfln = zrfln - zevapr;
        zsfln = zsfln - zevaps;
      }
    }

    // tendencies + first guess (:601-618)
    T zdqdt = -(zcondl + zcondi) + (plude + zevapr + zevaps) * zgdp;
    T zdtdt = zlvdcp * zcondl + zlsdcp * zcondi -
              (zlvdcp * zevapr + zlsdcp * zevaps + plude * zldcp -
               (zlsdcp - zlvdcp) * zrfreeze) *
                  zgdp;
    ztp1 = ztp1 + ptsphy * zdtdt;
    zqp1 = zqp1 + ptsphy * zdqdt;
    const T zqold = zqp1;

    // inlined saturation adjustment, two iterations (:628-669)
    const bool liquid = ztp1 > rtt;
    const T a3es = liquid ? c[C_R3LES] : c[C_R3IES];
    const T a4es = liquid ? c[C_R4LES] : c[C_R4IES];
    const T z5alcp = liquid ? c[C_R5ALVCP] : c[C_R5ALSCP];
    const T zaldcp = liquid ? c[C_RALVDCP] : c[C_RALSDCP];
    const T zqp = T(1.0) / pap;
    {
      const T foeew_a = c[C_R2ES] * xexp(a3es * (ztp1 - rtt) / (ztp1 - a4es));
      T qsat_a = xmin(zqp * foeew_a, T(0.5));
      const T cor_a = T(1.0) / (T(1.0) - c[C_RETV] * qsat_a);
      qsat_a = qsat_a * cor_a;
      const T z2s = z5alcp / sq(ztp1 - a4es);
      const T cond1 = (zqp1 - qsat_a) / (T(1.0) + qsat_a * cor_a * z2s);
      ztp1 = ztp1 + zaldcp * cond1;
      zqp1 = zqp1 - cond1;
    }
    {
      const T foeew_a = c[C_R2ES] * xexp(a3es * (ztp1 - rtt) / (ztp1 - a4es));
      T qsat_a = xmin(zqp * foeew_a, T(0.5));
      const T cor_a = T(1.0) / (T(1.0) - c[C_RETV] * qsat_a);
      qsat_a = qsat_a * cor_a;
      const T z2s = z5alcp / sq(ztp1 - a4es);
      const T cond1 = (zqp1 - qsat_a) / (T(1.0) + qsat_a * cor_a * z2s);
      ztp1 = ztp1 + zaldcp * cond1;
      zqp1 = zqp1 - cond1;
    }

    // post-adjustment accounting (:672-692)
    const T diff = zqold - zqp1;
    const T zdq = diff >= T(0.0) ? diff : T(0.0);
    const T zdr2 = c[C_ZCONS2] * zdp * zdq;
    const bool cold2 = ztp1 < rtt;
    const T zrfreeze2 = cold2 ? zfwat * zdr2 : T(0.0);
    zfwatr = cold2 ? T(0.0) : T(1.0);
    zcondl = zcondl + zfwatr * zdq * c[C_ZQTMST];
    zcondi = zcondi + (T(1.0) - zfwatr) * zdq * c[C_ZQTMST];
    zrfln = zrfln + zfwatr * zdr2;
    zsfln = zsfln + (T(1.0) - zfwatr) * zdr2;
    zrfreeze = zrfreeze + zrfreeze2;

    zdqdt = -(zcondl + zcondi) + (plude + zevapr + zevaps) * zgdp;
    zdtdt = zlvdcp * zcondl + zlsdcp * zcondi -
            (zlvdcp * zevapr + zlsdcp * zevaps + plude * zldcp -
             (zlsdcp - zlvdcp) * zrfreeze) *
                zgdp;

    a.out[O_TENL_T][i] = zdtdt;
    a.out[O_TENL_Q][i] = zdqdt;
    a.out[O_TENL_L][i] = (zqlwc - zl) * c[C_ZQTMST];
    a.out[O_TENL_I][i] = (zqiwc - zi) * c[C_ZQTMST];
    a.out[O_PCLC][i] = pclc;
    a.out[O_PCOVPTOT][i] = pcov;
    a.out[O_RFLN][i] = zrfln;
    a.out[O_SFLN][i] = zsfln;

    zrfl = zrfln;
    zsfl = zsfln;
    paph_lo = paph_hi;
  }
}

template <typename T, bool EVAP>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_nl_kernel(const __grid_constant__ Args<T> a, const int ncol,
                       const int nlev) {
  sweep<T, EVAP, false>(a, ncol, nlev);
}

template <typename T, bool EVAP>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_fwd_ckpt_kernel(const __grid_constant__ Args<T> a, const int ncol,
                             const int nlev) {
  sweep<T, EVAP, true>(a, ncol, nlev);
}

template <typename T, bool EVAP, bool FWD_CKPT>
int launch_variant(const Args<T>& a, int ncol, int nlev, cudaStream_t s) {
  const unsigned blocks = unsigned((int64_t(ncol) + kThreads - 1) / kThreads);
  if (FWD_CKPT) {
    cloudsc2_fwd_ckpt_kernel<T, EVAP><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  } else {
    cloudsc2_nl_kernel<T, EVAP><<<blocks, kThreads, 0, s>>>(a, ncol, nlev);
  }
  return int(cudaGetLastError());
}

template <typename T, bool FWD_CKPT>
int launch(const void* const* in, void* const* out, const double* consts,
           int ncol, int nlev, int evap, void* stream) {
  if (ncol <= 0 || nlev <= 0) return int(cudaErrorInvalidValue);
  Args<T> a = {};
  for (int j = 0; j < N_STREAM; ++j) a.in[j] = static_cast<const T*>(in[j]);
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  for (int j = 0; j < N_CONST; ++j) a.c[j] = T(consts[j]);
  if (FWD_CKPT) {
    a.pqs = static_cast<const T*>(in[N_STREAM]);
    for (int j = 0; j < 3; ++j) a.ckpt[j] = static_cast<T*>(out[N_OUTPUT + j]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return evap ? launch_variant<T, true, FWD_CKPT>(a, ncol, nlev, s)
              : launch_variant<T, false, FWD_CKPT>(a, ncol, nlev, s);
}

}  // namespace

extern "C" {

// Writes the lengths of the three argument arrays, so the caller can check
// that it was built against the same layout.
int cloudsc2_nl_abi(int* counts) {
  counts[0] = N_STREAM;
  counts[1] = N_OUTPUT;
  counts[2] = N_CONST;
  return 0;
}

// Launches the sweep on `stream` and returns the cudaError_t of the launch.
// `in` holds N_STREAM device pointers, `out` N_OUTPUT, `consts` N_CONST
// host doubles; every level array is (nlev, ncol) and paph (nlev+1, ncol).
int cloudsc2_nl_f32(const void* const* in, void* const* out,
                    const double* consts, int ncol, int nlev, int evap,
                    void* stream) {
  return launch<float, false>(in, out, consts, ncol, nlev, evap, stream);
}

int cloudsc2_nl_f64(const void* const* in, void* const* out,
                    const double* consts, int ncol, int nlev, int evap,
                    void* stream) {
  return launch<double, false>(in, out, consts, ncol, nlev, evap, stream);
}

// The lengths of the checkpointing sweep's argument arrays.
int cloudsc2_fwd_ckpt_abi(int* counts) {
  counts[0] = kFwdStreams;
  counts[1] = kFwdOutputs;
  counts[2] = N_CONST;
  return 0;
}

// Launches the checkpointing forward sweep on `stream` and returns the
// cudaError_t of the launch.  `in` holds kFwdStreams device pointers (the
// NL streams, then pqs), `out` kFwdOutputs (the 8 outputs, then the 3
// carry-in checkpoints, each (nlev, ncol)), `consts` N_CONST host doubles.
int cloudsc2_fwd_ckpt_f32(const void* const* in, void* const* out,
                          const double* consts, int ncol, int nlev, int evap,
                          void* stream) {
  return launch<float, true>(in, out, consts, ncol, nlev, evap, stream);
}

int cloudsc2_fwd_ckpt_f64(const void* const* in, void* const* out,
                          const double* consts, int ncol, int nlev, int evap,
                          void* stream) {
  return launch<double, true>(in, out, consts, ncol, nlev, evap, stream);
}

}  // extern "C"
