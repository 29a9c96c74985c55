// The four kernels of the unfused histogram round, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_hist.py:
//   cf_counts_kernel       <- _cf_kernel         (cf_counts_pallas)
//   coin_flips_kernel      <- _coin_kernel       (coin_flips_pallas)
//   equiv_counts_kernel    <- _equiv_kernel      (equiv_counts_pallas)
//   weak_coin_flips_kernel <- _weak_coin_kernel  (weak_coin_flips_pallas)
// Their plain torch versions live beside the wrappers in ops/hist.py.
//
// Layout.  The counts kernels write int32 [T, N, 3] (the class last, as
// the JAX wrappers stack h0, h1, hq), the coin kernels int8 [T, N].  Every
// random draw keys on the lane's GLOBAL (node, trial) counters, as
// _lane_ids does on the TPU, so the TPU's 512-lane tiles and their padding
// have no counterpart here: N needs no padding and the launch geometry
// moves no bit.  The per-trial counts are read from a [T, 3] f32 operand
// (the same f32 the TPU kernels get as [T, 1] blocks).
//
// The coin kernels run one thread per lane l = trial * N + node in a
// grid-stride loop (a 64-bit divide a lane splits l); they are issue-bound
// too (~119 and ~126 ops a lane against one byte).
//
// cf_counts and equiv_counts run a trial-aligned grid of one wave: the
// host gives each trial B blocks (hist_wave + ops/hist.py tile_blocks: as
// many as fit T times in the SMs times the blocks an SM holds, at least
// one, at most one per 256 nodes), block b serves trial b / B and walks
// nodes (b % B) * 256 + thread with a stride of B * 256, so trial and node
// are 32-bit values known without a divide a lane.  A block starts by
// computing its trial's terms: one thread the terms that depend on the
// histogram alone (stream.cuh cf_trial / equiv_trial) into shared memory,
// then every thread its share of a table of the per-lane draws' terms
// over a window of sample sizes (TermsTable).  A lane keeps its threefry,
// uniforms, clipped normal quantiles, cf_samples and the binomial split,
// and reads its own sample sizes' terms (m - p0; rem and rem - h0) from
// the table, computing them only outside the window.
//
// What bounds them, measured at N = 1M x 32 on an H100 (PERF.md).  Not
// bytes: 12 bytes a lane written (384 MB, 0.115 ms at 3.35 TB/s); a warp's
// three count stores cover 384 contiguous bytes, which L2 merges.  Not one
// pipe: the first ports issued 600 and 1014 static SASS instructions a
// lane's pass and ran at 1.20x and 1.12x that issue floor.  Taking the
// trial's terms and the 64-bit index out of the lanes cut the pass to 385
// and 763, but the terms held in registers (47 and 54) halved the blocks
// an SM holds and the kernels ran at 1.36x: latency the SM could not hide.
// So the launch bound asks for 8 blocks of 256 an SM (32 registers, a few
// spilled words: measured faster than 4 and 6), and the tables take the
// per-lane cf_terms' divides and square roots out of the lanes.  Not
// tried: staging the stores through shared memory (they are not the
// limit).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (ops/_build.py).  No fast-math: the kernels must round as
// torch's elementwise ops do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"

namespace {

constexpr int kThreads = 256;
// Grid cap of the coin kernels: the grid-stride loop walks the lanes
// beyond it.
constexpr size_t kMaxBlocks = (size_t)1 << 20;
// The blocks an SM must hold at once for the counts kernels: the launch
// bound caps their registers at 65536 / (256 * 8) = 32 a thread, the
// SM's full 64 warps (measured against 4 and 6 blocks: PERF.md).
constexpr int kMinBlocksPerSM = 8;

__device__ __forceinline__ size_t lane_begin() {
  return (size_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ size_t lane_stride() {
  return (size_t)gridDim.x * blockDim.x;
}

// Sample sizes in a block's tables of per-lane draw terms (stream.cuh
// TermsTable, 24 KB a block): at N = 1M a draw's sd is 150-250, so
// cf_counts' one table of +-1024 holds all but ~1e-5 of the lanes and
// equiv_counts' two of +-512 all but ~1e-3.
constexpr int kCfWindow = 2048;
constexpr int kEquivWindow = 1024;

// h0 ~ CF(total, c0, m), h1 | h0 ~ CF(total - c0, c1, m - h0),
// hq = m - h0 - h1 (pallas_hist.py _cf_kernel).  Grid T * B blocks: block
// b draws for trial b / B.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
cf_counts_kernel(const float* __restrict__ hist, int* __restrict__ out,
                 int N, int B, uint32_t k0, uint32_t k1, float m) {
  // one thread computes the trial's terms, every thread copies them and
  // fills its share of the second draw's table
  __shared__ benor::CfTrial ct_s;
  __shared__ benor::TermsTable<kCfWindow> tab;
  const uint32_t trial = blockIdx.x / (uint32_t)B;
  if (threadIdx.x == 0)
    ct_s = benor::cf_trial(hist[trial * 3 + 0], hist[trial * 3 + 1],
                           hist[trial * 3 + 2], m);
  __syncthreads();
  const benor::CfTrial ct = ct_s;
  benor::fill_table(&tab, ct.pop2,
                    fmaxf(m - benor::centre_draw(ct.d1), 0.0f));
  __syncthreads();
  int* const o = out + (size_t)trial * N * 3;
  const uint32_t stride = (uint32_t)B * kThreads;
  for (uint32_t node = (blockIdx.x - trial * B) * kThreads + threadIdx.x;
       node < (uint32_t)N; node += stride) {
    uint32_t b0, b1;
    benor::threefry2x32(k0, k1, node, trial, &b0, &b1);
    const float h0 = benor::cf_sample(benor::bits_to_uniform(b0), ct.d1);
    const float h1 = benor::cf_sample(
        benor::bits_to_uniform(b1),
        benor::table_terms(tab, ct.pop2, fmaxf(m - h0, 0.0f)));
    const float hq = fmaxf(m - h0 - h1, 0.0f);
    int* const p = o + (size_t)node * 3;
    p[0] = (int)h0;
    p[1] = (int)h1;
    p[2] = (int)hq;
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
// a normal-quantile Binomial(h_b, 1/2) class split of the h_b.  Grid as
// cf_counts_kernel's.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
equiv_counts_kernel(const float* __restrict__ hist,
                    const float* __restrict__ n_equiv,
                    int* __restrict__ out, int N, int B, uint32_t k0,
                    uint32_t k1, uint32_t k20, uint32_t k21, float m) {
  __shared__ benor::EquivTrial et_s;
  __shared__ benor::TermsTable<kEquivWindow> rem_tab, rest_tab;
  const uint32_t trial = blockIdx.x / (uint32_t)B;
  if (threadIdx.x == 0)
    et_s = benor::equiv_trial(hist[trial * 3 + 0], hist[trial * 3 + 1],
                              hist[trial * 3 + 2], n_equiv[trial], m);
  __syncthreads();
  const benor::EquivTrial et = et_s;
  benor::fill_equiv_tables(et, &rem_tab, &rest_tab);
  __syncthreads();
  int* const o = out + (size_t)trial * N * 3;
  const uint32_t stride = (uint32_t)B * kThreads;
  for (uint32_t node = (blockIdx.x - trial * B) * kThreads + threadIdx.x;
       node < (uint32_t)N; node += stride) {
    uint32_t b0, b1, b2, b3;
    benor::threefry2x32(k0, k1, node, trial, &b0, &b1);
    benor::threefry2x32(k20, k21, node, trial, &b2, &b3);
    float n0, n1, nq;
    benor::equiv_draws(et, rem_tab, rest_tab, benor::bits_to_uniform(b0),
                       benor::bits_to_uniform(b1), benor::bits_to_uniform(b2),
                       benor::bits_to_uniform(b3), &n0, &n1, &nq);
    int* const p = o + (size_t)node * 3;
    p[0] = (int)n0;
    p[1] = (int)n1;
    p[2] = (int)nq;
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

// One wave of cf_counts (kernel 0) or equiv_counts (kernel 1) on the
// current device -> *wave: the SMs times the blocks of the kernel an SM
// holds.  The caller splits it over the trials (ops/hist.py tile_blocks),
// once per shape, and passes the blocks a trial to the launcher.  Returns
// the first failed query's cudaError (0 = *wave set).
extern "C" int benor_hist_wave(int kernel, int* wave) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        kernel == 0 ? (const void*)cf_counts_kernel
                    : (const void*)equiv_counts_kernel,
        kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *wave = sms * per_sm;
  return 0;
}

extern "C" int benor_cf_counts(const float* hist, int* out, int T, int N,
                               int B, uint32_t k0, uint32_t k1, float m,
                               cudaStream_t stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cf_counts_kernel<<<T * B, kThreads, 0, stream>>>(hist, out, N, B, k0, k1,
                                                   m);
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
                                  int* out, int T, int N, int B, uint32_t k0,
                                  uint32_t k1, uint32_t k20, uint32_t k21,
                                  float m, cudaStream_t stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  equiv_counts_kernel<<<T * B, kThreads, 0, stream>>>(
      hist, n_equiv, out, N, B, k0, k1, k20, k21, m);
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
