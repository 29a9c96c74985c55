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
//
// Every add is written as a multiply-add by ``one``, which must be 1.
// With the default the compiler folds it back to an add.  A caller that
// passes a 1 the compiler cannot see (a kernel argument) gets the adds as
// IMAD, which issue to the FMA-heavy pipe, instead of IADD3 on the ALU,
// where the rotates (SHF) and xors (LOP3) already fill every slot: the
// coin kernels, which are nothing but this block (PERF.md).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t* y0, uint32_t* y1,
                                             uint32_t one = 1u) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 = k0 * one + x0;
  x1 = k1 * one + x1;
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = x1 * one + x0;
      x1 = rotl32(x1, rot[group & 1][i]) ^ x0;
    }
    x0 = ks[(group + 1) % 3] * one + x0;
    x1 = (ks[(group + 2) % 3] + (uint32_t)(group + 1)) * one + x1;
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

// A block's table of a population's cf_terms over a window of W sample
// sizes, n = base + i.  The lanes of a trial draw a per-lane sample size
// near one value, so a lane whose n falls in the window reads the terms
// that depend on n alone (mean, sd, skew) instead of computing them (two
// IEEE divides and two square roots); the table holds the same f32
// expression of the same f32 n, so the draw is the same bit for bit.  A
// lane outside the window computes its terms.
template <int W>
struct TermsTable {
  float base;               // an integer-valued float
  float mean[W], sd[W], skew[W];
};

// A draw's value at z = 0 (the rint of its mean, clamped to its support):
// what the next draw's sample size is centred on.
__device__ __forceinline__ float centre_draw(const CfTerms& d) {
  return fminf(fmaxf(rintf(d.mean), d.lo), d.hi);
}

// Every thread of the block fills its share of the table for a window
// centred on `center` (the trial's expected n); the caller synchronises
// the block before a lane reads it.
template <int W>
__device__ __forceinline__ void fill_table(TermsTable<W>* tab,
                                           const CfPop& pop, float center) {
  const float base = rintf(center) - (float)(W / 2);
  if (threadIdx.x == 0) tab->base = base;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const CfTerms d = cf_terms(pop, base + (float)i);
    tab->mean[i] = d.mean;
    tab->sd[i] = d.sd;
    tab->skew[i] = d.skew;
  }
}

// cf_terms(pop, n), read from the table where n is one of its sample
// sizes, else computed.
template <int W>
__device__ __forceinline__ CfTerms table_terms(const TermsTable<W>& tab,
                                               const CfPop& pop, float n) {
  const float off = n - tab.base;
  if (off >= 0.0f && off < (float)W) {
    const int i = (int)off;
    if (tab.base + (float)i == n) {
      CfTerms d;
      d.mean = tab.mean[i];
      d.sd = tab.sd[i];
      d.skew = tab.skew[i];
      d.lo = fmaxf(n - pop.tmg, 0.0f);
      d.hi = fminf(pop.g, n);
      return d;
    }
  }
  return cf_terms(pop, n);
}

// The per-trial terms of the equivocate regime's mixed-population tally
// (pallas_hist.py _equiv_kernel): h_b ~ CF(total_h + n_equiv, n_equiv, m)
// whole, and the populations of h0 ~ CF(total_h, c0, rem) and h1 | h0 ~
// CF(max(total_h - c0, 0), c1, max(rem - h0, 0)), whose sample sizes are
// the lane's.
struct EquivTrial {
  CfTerms db;
  CfPop pop0, pop1;
  float m;
};

__device__ __forceinline__ EquivTrial equiv_trial(float c0, float c1,
                                                  float cq, float ne,
                                                  float m) {
  const float total_h = c0 + c1 + cq;
  const float total = total_h + ne;
  EquivTrial e;
  e.db = cf_terms(cf_pop(total, ne), m);
  e.pop0 = cf_pop(total_h, c0);
  e.pop1 = cf_pop(fmaxf(total_h - c0, 0.0f), c1);
  e.m = m;
  return e;
}

// The tables of the two per-lane sample sizes of the equivocate tally:
// h0's rem = max(m - h_b, 0), centred on m less h_b's centre draw, and
// h1's max(rem - h0, 0), centred on that less h0's centre draw there.
template <int W>
__device__ __forceinline__ void fill_equiv_tables(const EquivTrial& e,
                                                  TermsTable<W>* rem_tab,
                                                  TermsTable<W>* rest_tab) {
  const float rem = fmaxf(e.m - centre_draw(e.db), 0.0f);
  fill_table(rem_tab, e.pop0, rem);
  fill_table(rest_tab, e.pop1,
             fmaxf(rem - centre_draw(cf_terms(e.pop0, rem)), 0.0f));
}

// One lane's equivocate tally from its trial's terms and its four uniforms
// (u0, u1 of the phase stream, u_b, u_s of the phase + 64 stream) -> the
// class-0, class-1 and "?" counts it receives: h_b delivered equivocators,
// the honest split of the rest, and a normal-quantile Binomial(h_b, 1/2)
// class split of the h_b.  ``terms0(n)`` / ``terms1(n)`` give cf_terms of
// h0's and h1's populations at the lane's sample size n.
template <typename Terms0, typename Terms1>
__device__ __forceinline__ void equiv_draws_with(const EquivTrial& e,
                                                 Terms0 terms0,
                                                 Terms1 terms1, float u0,
                                                 float u1, float u_b,
                                                 float u_s, float* n0,
                                                 float* n1, float* nq) {
  const float h_b = cf_sample(u_b, e.db);
  const float rem = fmaxf(e.m - h_b, 0.0f);
  const float h0 = cf_sample(u0, terms0(rem));
  const float h1 = cf_sample(u1, terms1(fmaxf(rem - h0, 0.0f)));
  *nq = fmaxf(rem - h0 - h1, 0.0f);
  const float z = ndtri_clipped(u_s);
  const float bs =
      fminf(fmaxf(rintf(h_b * 0.5f + z * sqrtf(h_b) * 0.5f), 0.0f), h_b);
  *n0 = h0 + (h_b - bs);
  *n1 = h1 + bs;
}

// The tally with the terms of h0's and h1's sample sizes read from the
// block's two tables (equiv_counts).
template <int W>
__device__ __forceinline__ void equiv_draws(const EquivTrial& e,
                                            const TermsTable<W>& rem_tab,
                                            const TermsTable<W>& rest_tab,
                                            float u0, float u1, float u_b,
                                            float u_s, float* n0, float* n1,
                                            float* nq) {
  equiv_draws_with(
      e, [&](float n) { return table_terms(rem_tab, e.pop0, n); },
      [&](float n) { return table_terms(rest_tab, e.pop1, n); }, u0, u1,
      u_b, u_s, n0, n1, nq);
}

// The tally with every sample size's terms computed (the round kernels,
// which hold no tables).
__device__ __forceinline__ void equiv_draws(const EquivTrial& e, float u0,
                                            float u1, float u_b, float u_s,
                                            float* n0, float* n1,
                                            float* nq) {
  equiv_draws_with(
      e, [&](float n) { return cf_terms(e.pop0, n); },
      [&](float n) { return cf_terms(e.pop1, n); }, u0, u1, u_b, u_s, n0,
      n1, nq);
}

}  // namespace benor
