// Shared device math of the round kernels: the __device__ twins of
// benor_tpu_torch/ops/stream.py (which ports benor_tpu/ops/pallas_hist.py:
// _threefry2x32, _bits_to_uniform, _ndtri_as241, _cf_draw).
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

// Inverse normal CDF, Wichura AS241 PPND7.
__device__ __forceinline__ float ndtri_as241(float p) {
  const float q = p - 0.5f;
  const float r_c = BENOR_F32(0.180625) - q * q;
  const float num_c = ((BENOR_F32(5.9109374720e+01) * r_c +
                        BENOR_F32(1.5929113202e+02)) * r_c +
                       BENOR_F32(5.0434271938e+01)) * r_c +
                      BENOR_F32(3.3871327179e+00);
  const float den_c = ((BENOR_F32(6.7187563600e+01) * r_c +
                        BENOR_F32(7.8757757664e+01)) * r_c +
                       BENOR_F32(1.7895169469e+01)) * r_c + 1.0f;
  const float central = q * num_c / den_c;

  const float r_t = sqrtf(-logf(fminf(p, 1.0f - p)));
  const float r_m = r_t - BENOR_F32(1.6);
  const float num_m = ((BENOR_F32(1.7023821103e-01) * r_m +
                        BENOR_F32(1.3067284816e+00)) * r_m +
                       BENOR_F32(2.7568153900e+00)) * r_m +
                      BENOR_F32(1.4234372777e+00);
  const float den_m = (BENOR_F32(1.2021132975e-01) * r_m +
                       BENOR_F32(7.3700164250e-01)) * r_m + 1.0f;
  const float r_f = r_t - 5.0f;
  const float num_f = ((BENOR_F32(1.7337203997e-02) * r_f +
                        BENOR_F32(4.2868294337e-01)) * r_f +
                       BENOR_F32(3.0812263860e+00)) * r_f +
                      BENOR_F32(6.6579051150e+00);
  const float den_f = (BENOR_F32(1.2258202635e-02) * r_f +
                       BENOR_F32(2.4197894225e-01)) * r_f + 1.0f;
  const float tail_m = num_m / den_m;
  const float tail_f = num_f / den_f;
  float tail = (r_t <= 5.0f) ? tail_m : tail_f;
  tail = (q < 0.0f) ? -tail : tail;
  return (fabsf(q) <= BENOR_F32(0.425)) ? central : tail;
}

// Skew-corrected (Cornish-Fisher) hypergeometric quantile draw of n from a
// population t with g successes, clamped to the support.
__device__ __forceinline__ float cf_draw(float u, float total, float good,
                                         float nsample) {
  const float t = fmaxf(total, 1.0f);
  const float g = good;
  const float n = nsample;
  const float p = g / t;
  const float mean = n * p;
  const float fpc_v = (t - n) / fmaxf(t - 1.0f, 1.0f);
  const float fpc = (t > 1.0f) ? fpc_v : 0.0f;
  const float var = fmaxf(n * p * (1.0f - p) * fpc, 0.0f);
  float z = ndtri_as241(u);
  const float denom = sqrtf(fmaxf(n * g * (t - g) * (t - n), 1.0f)) *
                      fmaxf(t - 2.0f, 1.0f);
  const float skew = (t - 2.0f * g) * sqrtf(fmaxf(t - 1.0f, 0.0f)) *
                     (t - 2.0f * n) / denom;
  z = z + (z * z - 1.0f) * skew / 6.0f;
  const float draw = rintf(mean + z * sqrtf(var));
  const float lo = fmaxf(n - (t - g), 0.0f);
  const float hi = fminf(g, n);
  return fminf(fmaxf(draw, lo), hi);
}

// The per-lane CF tally pair of one phase: one threefry block on the lane's
// global (node, trial) counters gives both uniforms; p0 ~ CF(total, c0, m),
// p1 | p0 ~ CF(total - c0, c1, m - p0).
__device__ __forceinline__ void cf_pair_draws(uint32_t k0, uint32_t k1,
                                              uint32_t node, uint32_t trial,
                                              float c0, float c1, float cq,
                                              float m, float* p0,
                                              float* p1) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, node, trial, &b0, &b1);
  const float u0 = bits_to_uniform(b0);
  const float u1 = bits_to_uniform(b1);
  const float total = c0 + c1 + cq;
  *p0 = cf_draw(u0, total, c0, m);
  *p1 = cf_draw(u1, fmaxf(total - c0, 0.0f), c1, fmaxf(m - *p0, 0.0f));
}

}  // namespace benor
