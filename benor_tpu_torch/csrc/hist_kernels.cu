// The four kernels of the unfused histogram round, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_hist.py:
//   cf_counts_kernel       <- _cf_kernel         (cf_counts_pallas)
//   coin_flips_kernel      <- _coin_kernel       (coin_flips_pallas)
//   equiv_counts_kernel    <- _equiv_kernel      (equiv_counts_pallas)
//   weak_coin_flips_kernel <- _weak_coin_kernel  (weak_coin_flips_pallas)
// Their plain torch versions live beside the wrappers in ops/hist.py.
//
// Layout.  One thread per (trial, node) lane, lane l = trial * N + node, in
// a grid-stride loop.  The counts kernels write int32 [T, N, 3] (the class
// last, as the JAX wrappers stack h0, h1, hq), the coin kernels int8
// [T, N].  Every random draw keys on the lane's GLOBAL (node, trial)
// counters, as _lane_ids does on the TPU, so the TPU's 512-lane tiles and
// their padding have no counterpart here: N needs no padding and the
// launch geometry moves no bit.  The per-trial counts are read from a
// [T, 3] f32 operand (the same f32 the TPU kernels get as [T, 1] blocks).
//
// What bounds them.  At N = 1M x 32 trials (the bench's north-star size):
//   cf_counts   one threefry-2x32-20 block (~117 integer ops), two
//               uniforms, two CF draws (stream.cuh cf_pair; each lane
//               also computes its trial's terms, a log, three square
//               roots and ~7 IEEE divides a draw) — ~300 ops a lane,
//               ~0.14 ms at 67 Tops/s, against 12 bytes a lane written
//               (384 MB, 0.115 ms at 3.35 TB/s): operations.
//   coin_flips  one block and a mask — ~119 ops a lane (0.057 ms) against
//               one byte (0.0096 ms): operations.
//   weak_coin   one block, a uniform, a compare and a select — ~126 ops
//               a lane (0.060 ms) against one byte: operations.
//   equiv       two blocks, four uniforms, three CF draws, one more normal
//               quantile and the binomial split — ~636 ops a lane
//               (0.30 ms) against 12 bytes (0.115 ms): operations.
// The simple design answers an operation bound by keeping every lane's
// arithmetic in registers — nothing touches memory but the count reads
// (cached, T x 3 floats) and the output stores — and by launching enough
// threads to fill every SM.  A warp's three count stores cover 384
// contiguous bytes, so L2 merges them into full sectors.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (ops/_build.py).  No fast-math: the kernels must round as
// torch's elementwise ops do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"

namespace {

constexpr int kThreads = 256;
// Grid cap: the grid-stride loop walks the lanes beyond it.
constexpr size_t kMaxBlocks = (size_t)1 << 20;

__device__ __forceinline__ size_t lane_begin() {
  return (size_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ size_t lane_stride() {
  return (size_t)gridDim.x * blockDim.x;
}

// h0 ~ CF(total, c0, m), h1 | h0 ~ CF(total - c0, c1, m - h0),
// hq = m - h0 - h1 (pallas_hist.py _cf_kernel).
__global__ void __launch_bounds__(kThreads)
cf_counts_kernel(const float* __restrict__ hist, int* __restrict__ out,
                 int N, size_t lanes, uint32_t k0, uint32_t k1, float m) {
  for (size_t l = lane_begin(); l < lanes; l += lane_stride()) {
    const uint32_t trial = (uint32_t)(l / (size_t)N);
    const uint32_t node = (uint32_t)(l - (size_t)trial * N);
    const float c0 = hist[trial * 3 + 0];
    const float c1 = hist[trial * 3 + 1];
    const float cq = hist[trial * 3 + 2];
    float h0, h1;
    benor::cf_pair(k0, k1, node, trial, benor::cf_trial(c0, c1, cq, m), &h0,
                   &h1);
    const float hq = fmaxf(m - h0 - h1, 0.0f);
    int* o = out + l * 3;
    o[0] = (int)h0;
    o[1] = (int)h1;
    o[2] = (int)hq;
  }
}

// Private coin: bit 0 of threefry word 0 (pallas_hist.py _coin_kernel).
__global__ void __launch_bounds__(kThreads)
coin_flips_kernel(int8_t* __restrict__ out, int N, size_t lanes, uint32_t k0,
                  uint32_t k1) {
  for (size_t l = lane_begin(); l < lanes; l += lane_stride()) {
    const uint32_t trial = (uint32_t)(l / (size_t)N);
    const uint32_t node = (uint32_t)(l - (size_t)trial * N);
    uint32_t b0, b1;
    benor::threefry2x32(k0, k1, node, trial, &b0, &b1);
    out[l] = (int8_t)(b0 & 1u);
  }
}

// Mixed-population sampler (pallas_hist.py _equiv_kernel): h_b delivered
// equivocators ~ CF(total, n_equiv, m), the honest split of the rest, and
// a normal-quantile Binomial(h_b, 1/2) class split of the h_b.
__global__ void __launch_bounds__(kThreads)
equiv_counts_kernel(const float* __restrict__ hist,
                    const float* __restrict__ n_equiv,
                    int* __restrict__ out, int N, size_t lanes,
                    uint32_t k0, uint32_t k1, uint32_t k20, uint32_t k21,
                    float m) {
  for (size_t l = lane_begin(); l < lanes; l += lane_stride()) {
    const uint32_t trial = (uint32_t)(l / (size_t)N);
    const uint32_t node = (uint32_t)(l - (size_t)trial * N);
    uint32_t b0, b1, b2, b3;
    benor::threefry2x32(k0, k1, node, trial, &b0, &b1);
    benor::threefry2x32(k20, k21, node, trial, &b2, &b3);
    const float u0 = benor::bits_to_uniform(b0);
    const float u1 = benor::bits_to_uniform(b1);
    const float u_b = benor::bits_to_uniform(b2);
    const float u_s = benor::bits_to_uniform(b3);

    const float c0 = hist[trial * 3 + 0];
    const float c1 = hist[trial * 3 + 1];
    const float cq = hist[trial * 3 + 2];
    const float ne = n_equiv[trial];
    const float total_h = c0 + c1 + cq;
    const float total = total_h + ne;
    const float h_b =
        benor::cf_sample(u_b, benor::cf_terms(benor::cf_pop(total, ne), m));
    const float rem = fmaxf(m - h_b, 0.0f);
    const float h0 =
        benor::cf_sample(u0, benor::cf_terms(benor::cf_pop(total_h, c0), rem));
    const float h1 = benor::cf_sample(
        u1, benor::cf_terms(benor::cf_pop(fmaxf(total_h - c0, 0.0f), c1),
                            fmaxf(rem - h0, 0.0f)));
    const float hq = fmaxf(rem - h0 - h1, 0.0f);
    const float z = benor::ndtri_clipped(u_s);
    const float bs =
        fminf(fmaxf(rintf(h_b * 0.5f + z * sqrtf(h_b) * 0.5f), 0.0f), h_b);
    int* o = out + l * 3;
    o[0] = (int)(h0 + (h_b - bs));
    o[1] = (int)(h1 + bs);
    o[2] = (int)hq;
  }
}

// Weak-common coin (pallas_hist.py _weak_coin_kernel): one block per lane,
// word 0 the private bit, word 1 the deviation uniform; uniform < eps takes
// the private bit, else the trial's shared bit.
__global__ void __launch_bounds__(kThreads)
weak_coin_flips_kernel(const int* __restrict__ shared,
                       int8_t* __restrict__ out, int N, size_t lanes,
                       uint32_t k0, uint32_t k1, float eps) {
  for (size_t l = lane_begin(); l < lanes; l += lane_stride()) {
    const uint32_t trial = (uint32_t)(l / (size_t)N);
    const uint32_t node = (uint32_t)(l - (size_t)trial * N);
    uint32_t pbits, dbits;
    benor::threefry2x32(k0, k1, node, trial, &pbits, &dbits);
    const int priv = (int)(pbits & 1u);
    const bool dev = benor::bits_to_uniform(dbits) < eps;
    out[l] = (int8_t)(dev ? priv : shared[trial]);
  }
}

int blocks_for(size_t lanes) {
  const size_t b = (lanes + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launch (0 = launched); an empty lane set
// launches nothing.

extern "C" int benor_cf_counts(const float* hist, int* out, int T, int N,
                               uint32_t k0, uint32_t k1, float m,
                               cudaStream_t stream) {
  const size_t lanes = (size_t)T * (size_t)N;
  if (lanes == 0) return 0;
  cf_counts_kernel<<<blocks_for(lanes), kThreads, 0, stream>>>(
      hist, out, N, lanes, k0, k1, m);
  return (int)cudaGetLastError();
}

extern "C" int benor_coin_flips(int8_t* out, int T, int N, uint32_t k0,
                                uint32_t k1, cudaStream_t stream) {
  const size_t lanes = (size_t)T * (size_t)N;
  if (lanes == 0) return 0;
  coin_flips_kernel<<<blocks_for(lanes), kThreads, 0, stream>>>(
      out, N, lanes, k0, k1);
  return (int)cudaGetLastError();
}

extern "C" int benor_equiv_counts(const float* hist, const float* n_equiv,
                                  int* out, int T, int N, uint32_t k0,
                                  uint32_t k1, uint32_t k20, uint32_t k21,
                                  float m, cudaStream_t stream) {
  const size_t lanes = (size_t)T * (size_t)N;
  if (lanes == 0) return 0;
  equiv_counts_kernel<<<blocks_for(lanes), kThreads, 0, stream>>>(
      hist, n_equiv, out, N, lanes, k0, k1, k20, k21, m);
  return (int)cudaGetLastError();
}

extern "C" int benor_weak_coin_flips(const int* shared, int8_t* out, int T,
                                     int N, uint32_t k0, uint32_t k1,
                                     float eps, cudaStream_t stream) {
  const size_t lanes = (size_t)T * (size_t)N;
  if (lanes == 0) return 0;
  weak_coin_flips_kernel<<<blocks_for(lanes), kThreads, 0, stream>>>(
      shared, out, N, lanes, k0, k1, eps);
  return (int)cudaGetLastError();
}
