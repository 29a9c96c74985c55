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
// The coin kernels (coin_flips_kernel <- _coin_kernel, weak_coin_flips_
// kernel <- _weak_coin_kernel) are one threefry block a lane against one
// byte stored: 32-bit integer work, ~70 SASS a lane, nearly all of it
// adds, rotates and xors.  What bounds them on the H100 (PERF.md): not
// bytes (32 MB, 0.0096 ms at 3.35 TB/s) but the ALU pipe (64 lanes a
// clock an SM), which takes every rotate (SHF) and xor (LOP3).  The first
// ports also paid a 64-bit divide a lane in a grid-stride loop and ran at
// 1.27x their ALU floor; these run at 1.05x.  They run the counts
// kernels' trial-aligned grid (below, B capped at one block per
// 256 x kCoinNodes nodes): trial and node are 32-bit, with no divide in
// the loop.  A thread takes kCoinNodes = 8 consecutive nodes a pass: 8
// independent threefry chains, whose bytes go out as one 64-bit store
// where the row's address is aligned (byte stores in an unaligned row and
// at the ragged end of a row).  The threefry adds issue as IMAD to the
// FMA-heavy pipe (threefry2x32's ``one``), leaving the ALU the rotates
// and xors.  The weak coin reads its trial's shared bit once, before the
// loop.  Measured and slower: 1 and 4 nodes a thread, rotates as
// IMAD.WIDE products (the times fit two FMA-heavy clocks each), and 8
// blocks an SM as the launch bound (the default holds 8 already).
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
// The blocks an SM must hold at once for the counts kernels: the launch
// bound caps their registers at 65536 / (256 * 8) = 32 a thread, the
// SM's full 64 warps (measured against 4 and 6 blocks: PERF.md).
constexpr int kMinBlocksPerSM = 8;
// Consecutive nodes a thread of the coin kernels takes in one pass of its
// loop (ops/hist.py COIN_NODES): as many independent threefry chains, and
// their coin bytes stored as one word.
constexpr int kCoinNodes = 8;
constexpr int kCoinBlockNodes = kThreads * kCoinNodes;

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

// The coin bytes c[0..kCoinNodes) of nodes node .. node + kCoinNodes - 1
// of a row: one 8-byte word where the row's address is 8-aligned
// (``wide``) and the nodes lie in the row, else one byte a node inside the
// row.
static_assert(kCoinNodes == sizeof(unsigned long long),
              "a pass's coin bytes fill one store word");
__device__ __forceinline__ void store_coins(int8_t* row, uint32_t node,
                                            uint32_t N, bool wide,
                                            const uint32_t (&c)[kCoinNodes]) {
  if (wide && node + kCoinNodes <= N) {
    unsigned long long w = 0;
#pragma unroll
    for (int j = 0; j < kCoinNodes; ++j)
      w |= (unsigned long long)c[j] << (8 * j);
    *reinterpret_cast<unsigned long long*>(row + node) = w;
  } else {
#pragma unroll
    for (int j = 0; j < kCoinNodes; ++j)
      if (node + j < N) row[node + j] = (int8_t)c[j];
  }
}

// The coin kernels' loop over the T * B blocks: block b serves trial
// b / B, and a pass of a thread takes kCoinNodes consecutive nodes, whose
// bytes coin(node) gives.
template <typename Coin>
__device__ __forceinline__ void coin_rows(int8_t* __restrict__ out, int N,
                                          int B, uint32_t trial, Coin coin) {
  int8_t* const row = out + (size_t)trial * N;
  const bool wide = (uintptr_t)row % kCoinNodes == 0;
  const uint32_t stride = (uint32_t)B * kCoinBlockNodes;
  for (uint32_t node = ((blockIdx.x - trial * B) * kThreads + threadIdx.x) *
                       kCoinNodes;
       node < (uint32_t)N; node += stride) {
    uint32_t c[kCoinNodes];
#pragma unroll
    for (int j = 0; j < kCoinNodes; ++j) c[j] = coin(node + j);
    store_coins(row, node, (uint32_t)N, wide, c);
  }
}

// Private coin: bit 0 of threefry word 0 (pallas_hist.py _coin_kernel).
// ``one`` is 1, an argument so that the compiler cannot fold it: the
// threefry adds then issue as IMAD (stream.cuh threefry2x32).
__global__ void __launch_bounds__(kThreads)
coin_flips_kernel(int8_t* __restrict__ out, int N, int B, uint32_t k0,
                  uint32_t k1, uint32_t one) {
  const uint32_t trial = blockIdx.x / (uint32_t)B;
  coin_rows(out, N, B, trial, [=](uint32_t node) {
    uint32_t b0, b1;
    benor::threefry2x32(k0, k1, node, trial, &b0, &b1, one);
    return b0 & 1u;
  });
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

// Weak-common coin (pallas_hist.py _weak_coin_kernel): word 0 the private
// bit, word 1 the deviation uniform; uniform < eps takes the private bit,
// else the trial's shared bit (its low byte, as the int8 cast keeps it),
// read once before the loop.  Grid and ``one`` as coin_flips_kernel's.
__global__ void __launch_bounds__(kThreads)
weak_coin_flips_kernel(const int* __restrict__ shared,
                       int8_t* __restrict__ out, int N, int B, uint32_t k0,
                       uint32_t k1, float eps, uint32_t one) {
  const uint32_t trial = blockIdx.x / (uint32_t)B;
  const uint32_t common = (uint8_t)shared[trial];
  coin_rows(out, N, B, trial, [=](uint32_t node) {
    uint32_t pbits, dbits;
    benor::threefry2x32(k0, k1, node, trial, &pbits, &dbits, one);
    return benor::bits_to_uniform(dbits) < eps ? pbits & 1u : common;
  });
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launch (0 = launched); an empty lane set
// launches nothing.

// One wave of cf_counts (kernel 0), equiv_counts (1), coin_flips (2) or
// weak_coin_flips (3) on the current device -> *wave: the SMs times the
// blocks of the kernel an SM holds.  The caller splits it over the trials
// (ops/hist.py tile_blocks), once per shape, and passes the blocks a trial
// to the launcher.  Returns the first failed query's cudaError (0 = *wave
// set).
extern "C" int benor_hist_wave(int kernel, int* wave) {
  const void* const kernels[] = {
      (const void*)cf_counts_kernel, (const void*)equiv_counts_kernel,
      (const void*)coin_flips_kernel, (const void*)weak_coin_flips_kernel};
  if (kernel < 0 || kernel > 3) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernels[kernel], kThreads, 0);
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

// The coins' blocks a trial: at least one, at most one per kCoinBlockNodes
// nodes (so that a node plus the stride stays below 2^32).
static bool coin_blocks_ok(int N, int B) {
  const long long cap =
      ((long long)N + kCoinBlockNodes - 1) / kCoinBlockNodes;
  return B >= 1 && B <= (cap > 1 ? cap : 1);
}

extern "C" int benor_coin_flips(int8_t* out, int T, int N, int B,
                                uint32_t k0, uint32_t k1,
                                cudaStream_t stream) {
  if (!coin_blocks_ok(N, B)) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  coin_flips_kernel<<<T * B, kThreads, 0, stream>>>(out, N, B, k0, k1, 1u);
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
                                     int N, int B, uint32_t k0, uint32_t k1,
                                     float eps, cudaStream_t stream) {
  if (!coin_blocks_ok(N, B)) return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  weak_coin_flips_kernel<<<T * B, kThreads, 0, stream>>>(shared, out, N, B,
                                                         k0, k1, eps, 1u);
  return (int)cudaGetLastError();
}
