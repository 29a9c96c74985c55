// Shared device math of the round kernels: the __device__ twins of
// benor_tpu_torch/ops/stream.py (which ports benor_tpu/ops/pallas_hist.py:
// _threefry2x32, _bits_to_uniform, _ndtri_as241, _cf_draw).
// The CF draw is split into per-trial and per-lane terms (cf_pop,
// cf_terms, cf_sample); the plain twins are written the same way.
//
// Every expression is written in the same order as its plain torch version,
// one rounding per operation: the library is built with -fmad=false (no
// multiply-add contraction) and without fast-math, so logf / sqrtf / IEEE
// division / rintf round exactly as torch's elementwise CUDA ops do.
// Constants are double literals cast to float, which is how JAX and torch
// turn their Python-float coefficients into f32.
#pragma once

#include <stdint.h>

#define BENOR_F32(v) ((float)(v))

namespace benor {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32-20 block cipher: key (k0, k1), counter (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[group & 1][i]) ^ x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + (uint32_t)(group + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// 32 random bits -> f32 uniform in (0, 1): the top 23 bits spliced into a
// [1, 2) mantissa, minus 1, clipped to [1e-7, 1 - 1e-7].
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fminf(fmaxf(f, BENOR_F32(1e-7)), BENOR_F32(1.0 - 1e-7));
}

// Inverse normal CDF, Wichura AS241 PPND7, for the p that bits_to_uniform
// returns.  Its clip to [1e-7, 1 - 1e-7] keeps r_t = sqrt(-log(min(p,
// 1 - p))) <= 4.02, so AS241's far-tail branch (r_t > 5) is never selected
// and is left out.  Selecting the numerator and denominator before one
// divide gives the same value as dividing both branches and selecting:
// -(a / b) == (-a) / b in IEEE round-to-nearest.
__device__ __forceinline__ float ndtri_clipped(float p) {
  const float q = p - 0.5f;
  const float r_c = BENOR_F32(0.180625) - q * q;
  const float num_c = ((BENOR_F32(5.9109374720e+01) * r_c +
                        BENOR_F32(1.5929113202e+02)) * r_c +
                       BENOR_F32(5.0434271938e+01)) * r_c +
                      BENOR_F32(3.3871327179e+00);
  const float den_c = ((BENOR_F32(6.7187563600e+01) * r_c +
                        BENOR_F32(7.8757757664e+01)) * r_c +
                       BENOR_F32(1.7895169469e+01)) * r_c + 1.0f;
  const float r_t = sqrtf(-logf(fminf(p, 1.0f - p)));
  const float r_m = r_t - BENOR_F32(1.6);
  const float num_m = ((BENOR_F32(1.7023821103e-01) * r_m +
                        BENOR_F32(1.3067284816e+00)) * r_m +
                       BENOR_F32(2.7568153900e+00)) * r_m +
                      BENOR_F32(1.4234372777e+00);
  const float den_m = (BENOR_F32(1.2021132975e-01) * r_m +
                       BENOR_F32(7.3700164250e-01)) * r_m + 1.0f;
  const bool central = fabsf(q) <= BENOR_F32(0.425);
  const float num = central ? q * num_c : (q < 0.0f ? -num_m : num_m);
  return num / (central ? den_c : den_m);
}

// The skew-corrected (Cornish-Fisher) hypergeometric quantile draw of n
// from a population t with g successes, clamped to the support, in three
// parts, so that a kernel computes each term where its inputs vary: the
// population's terms (cf_pop: per trial), the terms of the sample size
// (cf_terms: per trial where n is the quorum, per lane where n depends on
// the lane's first draw), and the lane's own remainder (cf_sample).  The
// three together are pallas_hist.py _cf_draw, expression for expression.
struct CfPop {
  float t, g, p, omp, tm1, tm2, tmg, a;
  int t_gt1;
};

__device__ __forceinline__ CfPop cf_pop(float total, float good) {
  CfPop c;
  c.t = fmaxf(total, 1.0f);
  c.g = good;
  c.p = c.g / c.t;
  c.omp = 1.0f - c.p;
  c.tm1 = fmaxf(c.t - 1.0f, 1.0f);
  c.t_gt1 = c.t > 1.0f;
  c.tm2 = fmaxf(c.t - 2.0f, 1.0f);
  c.tmg = c.t - c.g;
  c.a = (c.t - 2.0f * c.g) * sqrtf(fmaxf(c.t - 1.0f, 0.0f));
  return c;
}

struct CfTerms {
  float mean, sd, skew, lo, hi;
};

__device__ __forceinline__ CfTerms cf_terms(const CfPop& c, float n) {
  CfTerms d;
  d.mean = n * c.p;
  const float tmn = c.t - n;
  const float fpc = c.t_gt1 ? tmn / c.tm1 : 0.0f;
  d.sd = sqrtf(fmaxf(d.mean * c.omp * fpc, 0.0f));
  const float denom = sqrtf(fmaxf(n * c.g * c.tmg * tmn, 1.0f)) * c.tm2;
  d.skew = c.a * (c.t - 2.0f * n) / denom;
  d.lo = fmaxf(n - c.tmg, 0.0f);
  d.hi = fminf(c.g, n);
  return d;
}

__device__ __forceinline__ float cf_sample(float u, const CfTerms& d) {
  float z = ndtri_clipped(u);
  z = z + (z * z - 1.0f) * d.skew / 6.0f;
  return fminf(fmaxf(rintf(d.mean + z * d.sd), d.lo), d.hi);
}

// The per-trial terms of a phase's CF tally pair: p0 ~ CF(total, c0, m)
// whole, and the population of p1 | p0 ~ CF(max(total - c0, 0), c1,
// max(m - p0, 0)), whose sample size is the lane's.
struct CfTrial {
  CfTerms d1;
  CfPop pop2;
  float m;
};

__device__ __forceinline__ CfTrial cf_trial(float c0, float c1, float cq,
                                            float m) {
  const float total = c0 + c1 + cq;
  CfTrial c;
  c.d1 = cf_terms(cf_pop(total, c0), m);
  c.pop2 = cf_pop(fmaxf(total - c0, 0.0f), c1);
  c.m = m;
  return c;
}

// One lane's CF tally pair from its trial's terms: one threefry block on
// the lane's global (node, trial) counters gives both uniforms.
__device__ __forceinline__ void cf_pair(uint32_t k0, uint32_t k1,
                                        uint32_t node, uint32_t trial,
                                        const CfTrial& c, float* p0,
                                        float* p1) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, node, trial, &b0, &b1);
  *p0 = cf_sample(bits_to_uniform(b0), c.d1);
  *p1 = cf_sample(bits_to_uniform(b1),
                  cf_terms(c.pop2, fmaxf(c.m - *p0, 0.0f)));
}

}  // namespace benor
