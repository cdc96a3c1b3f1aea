// CLOUDSC2 nonlinear sweep: one thread owns one column.  The hand-written
// level body and the level loop around it, shared by four kernels:
//
// * `cloudsc2_nl_kernel` (cloudsc2_nl.cu) replaces the TPU kernel
//   `_stream_kernel` (cloudsc2jax/pallas/cloudsc2_kernel.py:348) run with
//   fuse_satur=True, whose level body is `_level_physics` (:78-345).  qsat is
//   SATUR of pt and pap, computed in registers; no pqs stream is read.
// * `cloudsc2_fwd_ckpt_kernel` (cloudsc2_nl.cu) replaces `_fwd_ckpt_kernel`
//   (cloudsc2jax/pallas/tlad_kernel.py:405), the forward sweep of the
//   standalone adjoint: pqs READ as a stream (it is one of the
//   differentiated inputs, and the reverse sweep recomputes each level from
//   the streamed value, so the checkpoints must come from that trajectory
//   and not from SATUR of pt and pap), and the carry going INTO each level
//   (rfl, sfl, covptot) written as 3 checkpoint streams.
// * `cloudsc2_nl_enc_kernel` (cloudsc2_nl_enc.cu) replaces
//   `_stream_kernel(encoded=...)`: the same loop with the load policy
//   cloudsc2_load::LevelMajorT, pqs computed or streamed.
// * `cloudsc2_nl_res_kernel` (cloudsc2_nl_res.cu) replaces
//   `_resident_kernel`: its own loop, which reads a level from shared memory,
//   around the same `level`.
//
// "pqs is a stream" (PQS_STREAM) and "write the checkpoints" (CKPT) are
// separate template flags of `sweep_column`; how a stream value is loaded is
// its `Load` policy (cloudsc2_load.cuh).
//
// The arithmetic of `level` follows `_level_physics` line by line, with the
// same association and the same strict or non-strict comparisons; constants
// that Python folds in double before they meet an array (zcons2, zckcodtl,
// 1.9*rclcrit, rcpd*rvtmp2, ...) arrive folded from the host in `Args::c`
// and are rounded to T once.
//
// Schedule.  On the TPU the grid ran (column block, level) in order and
// carried rfl/sfl/covptot in VMEM scratch from one level step to the next.
// Here blocks run in no order, so each thread loops over the 137 levels of
// its own column with the carry in registers.  The arrays are levels-major
// (nlev, ncol) with no column padding: a level read by a warp is one
// coalesced row segment, and the ragged last block masks its tail.
// paph(k+1) of step k is kept as paph(k) of step k+1, so each input stream
// is read once per level; plu(k+1) is clamped at the last level as in
// `_level_index_maps` (:522-536).
//
// What bounds it on this card: device-memory bytes.  Per level and column
// the sweep reads 15 values and writes 8 (92 bytes in f32; the checkpointing
// sweep 16 and 11, 108 bytes) for about 300 flops and 12 transcendentals,
// far below the H100's flop/byte balance.  Measured on an NVIDIA H100 (700
// W) at 327,680 f32 columns: 1.73 ms (NL) and 2.19-2.23 ms (checkpointing)
// against bytes bounds of 1.23 and 1.45 ms (PERF.md).
// The design therefore moves each byte once: no relayout before or after,
// one read per stream, no intermediate written back, the carry in
// registers.
//
// Built with nvcc for sm_90a by cloudsc2jax_torch/kernels/build.py, without
// --use_fast_math: exp, tanh, sqrt and pow are the IEEE-accurate library
// functions.  FMA contraction is allowed.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cloudsc2_load.cuh"

namespace cloudsc2_nl {

constexpr int kThreads = 128;

// Pointer order of Args::in.  Without pqs it is KERNEL_STREAMS of
// cloudsc2jax_torch/kernels/cloudsc2_kernel.py; with pqs it is the order of
// the TL and AD sweeps (TL_STREAMS).  Either way the first PAPH + 1 entries
// are the streams of an encoding with the matching `fuse_satur`
// (EncodedInputs.names), so bit j of an encoding's mask and pair j of each
// row of its level-major table belong to in[j].  Tests check the Python
// tuples against these.
template <bool PQS_STREAM>
struct Order {
  static constexpr int P = PQS_STREAM ? 1 : 0;
  enum : int {
    PT = 0, PQ = 1, PQS = 2,  // PQS only with PQS_STREAM
    PAP = 2 + P, PL, PI, PLUDE, PMFU, PMFD, TEN_T, TEN_Q, TEN_L, TEN_I,
    PSUPSAT, PLU, PAPH, CETA, ZSCALM, ZTRPAUS, PAPH_SFC,
    N
  };
};
constexpr int kMaxStreams = Order<true>::N;

// The values of one level that `level` takes, in the order of the plain
// version's `fields` (level_physics): the 14 level rows, then plu(k+1),
// paph(k) and paph(k+1).  With pqs a stream, stream j < PLU is value j.
enum Value {
  X_PT, X_PQ, X_PQS, X_PAP, X_PL, X_PI, X_PLUDE, X_PMFU, X_PMFD,
  X_TEN_T, X_TEN_Q, X_TEN_L, X_TEN_I, X_PSUPSAT, X_PLU_K1, X_PAPH_LO,
  X_PAPH_HI,
  N_VALUE
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

template <typename T>
struct Args {
  const T* in[kMaxStreams];
  T* out[N_OUTPUT];
  T* ckpt[3];  // CKPT only: rfl, sfl, covptot going into each level
  T c[N_CONST];
  // cloudsc2_load::LevelMajorT only: the level-major (table_rows, 16, 2)
  // [scale, offset] table and the streams that hold 16-bit payloads, bit j
  // for in[j]
  const float2* table;
  int table_rows;
  unsigned enc_mask;
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

// One level of one column: x holds its N_VALUE inputs, (zrfl, zsfl,
// zcovptot) the carry, which is updated; y receives the N_OUTPUT outputs.
// ptsphy, rtt and rg are c[C_PTSPHY], c[C_RTT] and c[C_RG], read by the caller
// before its level loop, and `sweep_column` loads ceta and zscalm after the
// streams' values: with the three read here and the two loaded before the
// decode, the f32 NL kernel compiled to 51 registers where it had 48 and ran
// 5% slower on an NVIDIA H100 (PERF.md).
template <typename T, bool EVAP>
__device__ __forceinline__ void level(const T* c, const T (&x)[N_VALUE],
                                      const T ceta_k, const T zscalm_k,
                                      const bool not_last, const T ptsphy,
                                      const T rtt, const T rg, const T ztrpaus,
                                      const T paph_sfc, T& zrfl, T& zsfl,
                                      T& zcovptot, T (&y)[N_OUTPUT]) {
  const T pt = x[X_PT], pq = x[X_PQ], pqs = x[X_PQS], pap = x[X_PAP];
  const T pl = x[X_PL], pi = x[X_PI], plude = x[X_PLUDE];
  const T pmfu = x[X_PMFU], pmfd = x[X_PMFD];
  const T ten_t = x[X_TEN_T], ten_q = x[X_TEN_Q];
  const T ten_l = x[X_TEN_L], ten_i = x[X_TEN_I];
  const T psupsat = x[X_PSUPSAT], plu_k1 = x[X_PLU_K1];
  const T paph_lo = x[X_PAPH_LO], paph_hi = x[X_PAPH_HI];

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

  y[O_TENL_T] = zdtdt;
  y[O_TENL_Q] = zdqdt;
  y[O_TENL_L] = (zqlwc - zl) * c[C_ZQTMST];
  y[O_TENL_I] = (zqiwc - zi) * c[C_ZQTMST];
  y[O_PCLC] = pclc;
  y[O_PCOVPTOT] = pcov;
  y[O_RFLN] = zrfln;
  y[O_SFLN] = zsfln;

  zrfl = zrfln;
  zsfl = zsfln;
}

// The level loop of one column.  PQS_STREAM reads pqs where the sweep
// otherwise computes SATUR of pt and pap; CKPT writes the carry going into
// each level.  Every stream's load of a level is issued before any is
// decoded (cloudsc2_load.cuh says why).
template <typename T, bool EVAP, bool PQS_STREAM, bool CKPT, typename Load>
__device__ __forceinline__ void sweep_column(const Args<T>& a, const int ncol,
                                             const int nlev,
                                             const int64_t col) {
  using O = Order<PQS_STREAM>;
  const T* c = a.c;
  const T ptsphy = c[C_PTSPHY];
  const T rtt = c[C_RTT];
  const T rg = c[C_RG];
  const T ztrpaus = __ldg(a.in[O::ZTRPAUS] + col);
  const T paph_sfc = __ldg(a.in[O::PAPH_SFC] + col);
  T zrfl = T(0.0), zsfl = T(0.0), zcovptot = T(0.0);
  T paph_lo = Load::template value<T>(
      a, O::PAPH, 0, Load::template fetch<T>(a, O::PAPH, col));

  for (int k = 0; k < nlev; ++k) {
    const int64_t i = int64_t(k) * ncol + col;
    const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
    const int64_t i1 = int64_t(k1) * ncol + col;
    const int64_t ihi = int64_t(k + 1) * ncol + col;
    // stream j < PLU is value j, or j + 1 past the pqs that is not streamed
    T x[N_VALUE];
#pragma unroll
    for (int j = 0; j < O::PLU; ++j) {
      x[PQS_STREAM || j < X_PQS ? j : j + 1] = Load::template fetch<T>(a, j, i);
    }
    x[X_PLU_K1] = Load::template fetch<T>(a, O::PLU, i1);
    x[X_PAPH_HI] = Load::template fetch<T>(a, O::PAPH, ihi);
#pragma unroll
    for (int j = 0; j < O::PLU; ++j) {
      const int v = PQS_STREAM || j < X_PQS ? j : j + 1;
      x[v] = Load::template value<T>(a, j, k, x[v]);
    }
    x[X_PLU_K1] = Load::template value<T>(a, O::PLU, k1, x[X_PLU_K1]);
    x[X_PAPH_LO] = paph_lo;
    x[X_PAPH_HI] = Load::template value<T>(a, O::PAPH, k + 1, x[X_PAPH_HI]);
    const T ceta_k = __ldg(a.in[O::CETA] + k);
    const T zscalm_k = __ldg(a.in[O::ZSCALM] + k);
    if (!PQS_STREAM) x[X_PQS] = satur(c, x[X_PAP], x[X_PT]);
    if (CKPT) {
      a.ckpt[0][i] = zrfl;
      a.ckpt[1][i] = zsfl;
      a.ckpt[2][i] = zcovptot;
    }

    T y[N_OUTPUT];
    level<T, EVAP>(c, x, ceta_k, zscalm_k, k < nlev - 1, ptsphy, rtt, rg,
                   ztrpaus, paph_sfc, zrfl, zsfl, zcovptot, y);
#pragma unroll
    for (int j = 0; j < N_OUTPUT; ++j) a.out[j][i] = y[j];
    paph_lo = x[X_PAPH_HI];  // decoded, where paph is encoded
  }
}

// One thread per column, the ragged last block masked.
template <typename T, bool EVAP, bool PQS_STREAM, bool CKPT, typename Load>
__device__ __forceinline__ void sweep(const Args<T>& a, const int ncol,
                                      const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  sweep_column<T, EVAP, PQS_STREAM, CKPT, Load>(a, ncol, nlev, col);
}

// Fills Args::out and Args::c from the launcher's arrays: `out` holds
// N_OUTPUT device pointers, `consts` N_CONST host doubles.
template <typename T>
void fill_outputs(Args<T>& a, void* const* out, const double* consts) {
  for (int j = 0; j < N_OUTPUT; ++j) a.out[j] = static_cast<T*>(out[j]);
  for (int j = 0; j < N_CONST; ++j) a.c[j] = T(consts[j]);
}

inline unsigned blocks_for(int ncol, int threads) {
  return unsigned((int64_t(ncol) + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// The checkpointing forward sweep with C levels a step: `_fwd_ckpt_kernel`
// with `chunk` > 1 (cloudsc2jax/pallas/tlad_kernel.py:405, loop :427, the
// reads `_chunk_reads` :105), as `cloudsc2_pallas_ad(chunk_levels=C)` runs it
// before its reverse sweep (:694-711).
//
// A step first issues the loads of each of its C levels (16 values a level:
// the 14 rows, pqs among them, plu(k+1) clamped at the last level and
// paph(k+1)), the counterpart of the TPU's C-level DMA window, then runs the
// C level bodies in ascending order, each on the values at the head of the
// window, which moves up one level after each body; the bodies are one loop
// that is not unrolled, so the window costs 16 (C-1) live values and not a
// copy of the body per level.  The last, partial step (137 is prime) loads
// and runs only the levels that exist.  Every level runs
// `cloudsc2_fwd_ckpt_kernel`'s body on the same values in the same order, so
// the outputs and checkpoints are that kernel's bit for bit.
template <typename T, bool EVAP, int C>
__device__ __forceinline__ void fwd_ckpt_column_chunked(const Args<T>& a,
                                                        const int ncol,
                                                        const int nlev,
                                                        const int64_t col) {
  using O = Order<true>;
  const T* c = a.c;
  const T ptsphy = c[C_PTSPHY];
  const T rtt = c[C_RTT];
  const T rg = c[C_RG];
  const T ztrpaus = __ldg(a.in[O::ZTRPAUS] + col);
  const T paph_sfc = __ldg(a.in[O::PAPH_SFC] + col);
  T zrfl = T(0.0), zsfl = T(0.0), zcovptot = T(0.0);
  T paph_lo = __ldg(a.in[O::PAPH] + col);

  for (int k0 = 0; k0 < nlev; k0 += C) {
    const int n = nlev - k0 < C ? nlev - k0 : C;  // levels k0 ... k0 + n - 1
    // per level: the 14 level rows, plu(k+1), paph(k+1)
    T w[C][O::PAPH + 1];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (m < n) {
        const int k = k0 + m;
        const int64_t i = int64_t(k) * ncol + col;
        const int k1 = k + 1 < nlev ? k + 1 : nlev - 1;
#pragma unroll
        for (int j = 0; j < O::PLU; ++j) w[m][j] = __ldg(a.in[j] + i);
        w[m][O::PLU] = __ldg(a.in[O::PLU] + int64_t(k1) * ncol + col);
        w[m][O::PAPH] = __ldg(a.in[O::PAPH] + int64_t(k + 1) * ncol + col);
      }
    }
#pragma unroll 1
    for (int m = 0; m < n; ++m) {
      const int k = k0 + m;
      const int64_t i = int64_t(k) * ncol + col;
      T x[N_VALUE];
#pragma unroll
      for (int j = 0; j < O::PLU; ++j) x[j] = w[0][j];
      x[X_PLU_K1] = w[0][O::PLU];
      x[X_PAPH_LO] = paph_lo;
      x[X_PAPH_HI] = w[0][O::PAPH];
      const T ceta_k = __ldg(a.in[O::CETA] + k);
      const T zscalm_k = __ldg(a.in[O::ZSCALM] + k);
      a.ckpt[0][i] = zrfl;
      a.ckpt[1][i] = zsfl;
      a.ckpt[2][i] = zcovptot;

      T y[N_OUTPUT];
      level<T, EVAP>(c, x, ceta_k, zscalm_k, k < nlev - 1, ptsphy, rtt, rg,
                     ztrpaus, paph_sfc, zrfl, zsfl, zcovptot, y);
#pragma unroll
      for (int j = 0; j < N_OUTPUT; ++j) a.out[j][i] = y[j];
      paph_lo = x[X_PAPH_HI];
#pragma unroll
      for (int mm = 0; mm + 1 < C; ++mm) {
#pragma unroll
        for (int j = 0; j <= O::PAPH; ++j) w[mm][j] = w[mm + 1][j];
      }
    }
  }
}

// One thread per column, the ragged last block masked; no register budget,
// as for cloudsc2_fwd_ckpt_kernel.
template <typename T, bool EVAP, int C>
__global__ void __launch_bounds__(kThreads)
    cloudsc2_fwd_chunk_kernel(const __grid_constant__ Args<T> a, const int ncol,
                              const int nlev) {
  const int64_t col = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= ncol) return;
  fwd_ckpt_column_chunked<T, EVAP, C>(a, ncol, nlev, col);
}

}  // namespace cloudsc2_nl
