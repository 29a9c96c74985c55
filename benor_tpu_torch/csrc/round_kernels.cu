// The three round kernels of the packed Ben-Or main path, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_round.py:
//   proposal_hist_kernel <- _prop_hist_kernel    (proposal_hist_pallas)
//   vote_commit_kernel   <- _vote_commit_kernel  (vote_commit_pallas)
//   fused_round_kernel   <- _fused_round_kernel  (fused_round_pallas),
//   fused_cluster_kernel    its cluster form (the same body)
// in the 'sampled' counts regime with private coins, crash or byzantine
// faults, either decision rule, freeze on or off.  Their plain torch
// versions live beside the wrappers in ops/packed_round.py.
//
// Layout.  The node state is a [T, P, n_w] stack of 32-bit plane words
// (state.PACK_LAYOUT): plane base + b holds bit b of a field for the 32
// nodes of a word, node id = word * 32 + bit.  One WARP handles one plane
// word at a time: lane L is node word * 32 + L.  Lane p < P loads plane p
// of the word, the planes every lane reads are shuffled out of those
// lanes, and lane p stores plane p of the new word.  Per-warp counts are
// popcounts of ballots and plane words, summed over the block in shared
// memory and written as int32 partials [blocks, T, cols]; the wrapper sums
// them over blocks (integer sums, so the order moves no bit).  Random
// draws key on the global (node, trial) counters, so the tiling never
// moves a bit either.
//
// What bounds them.  Not bytes: at N = 1M, T = 32, max_rounds = 64 the
// stack is 14 planes x 31,264 words x 4 B x 32 trials = 56 MB a read,
// 0.017 ms at 3.35 TB/s.  Not one pipe either.  Measured on an H100 SXM
// at 700 W and clocks.sm 1980 MHz (round_stats.py), the two-kernel pair
// as first ported issued 751 (proposal) and 1318 (vote) static SASS
// instructions a lane's pass; at one instruction a clock per scheduler
// over the 32,014,336 lanes that is 0.719 and 1.261 ms, against 0.714 and
// 1.275 ms measured: they were bound by instruction issue.  Their other
// floors: MUFU 0.168 ms, f32 0.259 ms, integer and compare 0.454 and
// 1.233 ms (the vote's plane addressing and rebuild).  So the design
// issues fewer instructions:
//  - the split CF draw (stream.cuh cf_trial, cf_pair): every term
//    of a draw that depends only on the trial's histogram and the quorum
//    is computed once a block, by one thread, into shared memory; a lane
//    keeps its threefry, uniforms, two clipped normal quantiles (no far
//    tail, one divide each) and the terms of its own sample size: 6 IEEE
//    divides, 4 square roots and 2 logs a pair instead of 14, 8 and 2;
//  - warp skips: a draw or coin that no lane of the warp reads is not
//    made (__any_sync);
//  - one load and one store a word, the load issued one word ahead (it
//    took 7-9 % off both kernels), the k planes rebuilt with bit
//    operations on the old words, counts from word masks;
//  - a persistent grid of one wave (the occupancy query's blocks an SM
//    times the SMs, spread over the trials), so the per-trial prologue
//    runs a few hundred times a launch, not 125,000 times.
// Occupancy: the first port used 35 and 48 registers (5-6 blocks of 8
// warps an SM) and was issue-bound, not latency-bound, so one word a warp
// is kept (no interleaved chains) and the launch bound only caps
// registers at 64 (4 blocks an SM).  TMA, wgmma and the tensor cores have
// no part here: there is no tile to stream (0.2 bytes a lane) and no
// product to compute.
//
// The fused kernel (N <= 8192 and T x Np <= 2^18, Np = N padded to 512)
// is bound by latency, not by issue.  As first ported, one block of 16
// warps a trial walked each of its up to 256 words twice, 1005 static SASS
// a word through both phases: at N = 8192 x 32 it ran on 32 of the 132
// SMs, 0.0480 ms of device time against an issue floor of 0.0079 ms over
// the card, and 0.0437 ms at T = 1 (launches queued; NVIDIA H100 80GB
// HBM3, 700.00 W, clocks.sm 1980 MHz, round_stats.py); there the
// two-kernel route took less device time.  So a trial's words are spread
// over a thread-block cluster of up to 16 blocks on as many SMs
// (fused_cluster_kernel), a warp's few words are loaded at once and kept
// in registers across the phase barrier, and the vote phase's whole-trial
// histogram goes from block to block through distributed shared memory:
// one launch, no second pass over the words in memory, no host-side sum.
// Where one block a trial is the best grid, fused_round_kernel runs the
// same body without the cluster's code.  ops/packed_round.py fused_grid
// picks the cluster size and block width from the occupancy query
// (benor_fused_fits): all T clusters at once, the most warps a trial, then
// no cluster where one block will do and else the smallest blocks.  A
// measured scan of every grid (round_stats.py --fused-scan, the same card,
// launches queued) ranks them so at each shape of the family: at
// N = 8192 x 32, 16 blocks of 4 warps (0.0187 ms) beat 4 of 16
// (0.0253 ms), since an SM then holds blocks of several trials, whose
// per-trial terms and barriers overlap the others' words.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/_build.py).  No fast-math: the
// kernels must round as torch's elementwise ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Warps of a block on the two-kernel path, and the blocks an SM must hold
// at once (the launch bound that caps registers at 65536 / (256 * 4) = 64
// a thread).
constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocksPerSM = 4;
// The fused kernel: a cluster of C blocks a trial, C in {1, 2, 4, 8, 16}
// (16 is a non-portable cluster size), of W in {16, 8, 4} warps; a warp
// holds at most kFusedKeep words.  Its launch bound, two blocks of 16
// warps an SM, caps registers at 64 a thread.
constexpr int kFusedMaxWarps = 16;
constexpr int kFusedMinBlocks = 2;
constexpr int kFusedKeep = 4;
constexpr int kFusedClusters[] = {1, 2, 4, 8, 16};
constexpr int kFusedWarpChoices[] = {16, 8, 4};
constexpr int kPortableCluster = 8;
// Plane layout (state.PACK_LAYOUT).
constexpr int kPlaneX = 0;        // 2 planes
constexpr int kPlaneDecided = 2;
constexpr int kPlaneKilled = 3;
constexpr int kPlaneCoined = 4;
constexpr int kPlaneFaulty = 5;
constexpr int kPlaneDown = 6;
constexpr int kPlaneK = 7;        // P - 7 planes
constexpr int kPropCols = 4;      // PROP_PARTIAL_LAYOUT
constexpr int kVoteCols = 5;      // VOTE_PARTIAL_LAYOUT
constexpr int kVal0 = 0, kVal1 = 1, kValQ = 2;

// One lane's view of its warp's word.  Lane p < P loads plane p's word
// (one load a warp); the planes every lane reads are shuffled out of those
// lanes.  The k planes stay in their lanes: no kernel needs a lane's k.
struct Lane {
  uint32_t plane;                 // plane `lane` of the word (lane < P)
  uint32_t dec_w, kil_w, fau_w;   // the word's decided / killed / faulty
  int x;
  bool decided, alive, faulty, frozen;
};

__device__ __forceinline__ bool lane_bit(uint32_t w, int lane) {
  return (w >> lane) & 1u;
}

// Plane `lane` of the word at `words`, 0 for lanes >= P or a word past
// the end (`in_range` false).
__device__ __forceinline__ uint32_t load_plane(const uint32_t* words, int P,
                                               size_t stride, int lane,
                                               bool in_range) {
  return (in_range && lane < P) ? words[lane * stride] : 0u;
}

__device__ __forceinline__ Lane lane_from(uint32_t plane, int lane,
                                          int freeze) {
  Lane f;
  f.plane = plane;
  const uint32_t x0 = __shfl_sync(kFull, f.plane, kPlaneX);
  const uint32_t x1 = __shfl_sync(kFull, f.plane, kPlaneX + 1);
  f.dec_w = __shfl_sync(kFull, f.plane, kPlaneDecided);
  f.kil_w = __shfl_sync(kFull, f.plane, kPlaneKilled);
  f.fau_w = __shfl_sync(kFull, f.plane, kPlaneFaulty);
  f.x = (int)lane_bit(x0, lane) | ((int)lane_bit(x1, lane) << 1);
  f.decided = lane_bit(f.dec_w, lane);
  f.alive = !lane_bit(f.kil_w, lane);
  f.faulty = lane_bit(f.fau_w, lane);
  f.frozen = freeze && f.decided;
  return f;
}

// Byzantine lanes broadcast bit-flipped values (0 <-> 1, "?" kept).
__device__ __forceinline__ int sent(int byz, int v, bool faulty) {
  if (byz && faulty) return v == kVal0 ? kVal1 : (v == kVal1 ? kVal0 : v);
  return v;
}

// One thread of the block computes its trial's CF terms into shared
// memory; every thread then copies them.  Holds a __syncthreads.
__device__ __forceinline__ benor::CfTrial block_cf_trial(
    benor::CfTrial* smem, float c0, float c1, float cq, float m) {
  if (threadIdx.x == 0) *smem = benor::cf_trial(c0, c1, cq, m);
  __syncthreads();
  return *smem;
}

// Proposal phase of one lane -> its sent vote value.  The CF pair is drawn
// only in warps with a lane alive and not frozen: a frozen lane sends its
// x and a dead lane is not counted, so no skipped draw is ever read.
__device__ __forceinline__ int proposal_vote(const Lane& f, uint32_t k0,
                                             uint32_t k1, uint32_t node,
                                             uint32_t trial,
                                             const benor::CfTrial& ct,
                                             int byz) {
  int x1 = f.x;
  if (__any_sync(kFull, f.alive && !f.frozen)) {
    float p0, p1;
    benor::cf_pair(k0, k1, node, trial, ct, &p0, &p1);
    x1 = p0 > p1 ? kVal0 : (p1 > p0 ? kVal1 : kValQ);
  }
  return sent(byz, f.frozen ? f.x : x1, f.faulty);
}

struct Commit {
  int x;
  bool decided, coined, active;
};

// Vote phase of one lane: tallies, coin, decide / adopt / commit
// (pallas_round.py _decide_commit).  The CF pair is drawn only in warps
// with an active lane (alive, quorum met, not frozen), and the coin's
// threefry block only in warps with an active lane that neither decides
// nor adopts: every other lane keeps its fields, so no skipped value is
// ever read.
__device__ __forceinline__ Commit vote_lane(const Lane& f, uint32_t vk0,
                                            uint32_t vk1, uint32_t ck0,
                                            uint32_t ck1, uint32_t node,
                                            uint32_t trial,
                                            const benor::CfTrial& ct,
                                            float nf, int qok, int textbook) {
  Commit c{f.x, f.decided, false, f.alive && qok != 0 && !f.frozen};
  if (!__any_sync(kFull, c.active)) return c;
  float v0, v1;
  benor::cf_pair(vk0, vk1, node, trial, ct, &v0, &v1);
  const bool decide0 = v0 > nf;
  const bool decide1 = v1 > nf;
  bool adopt0 = false, adopt1 = false;
  if (!textbook) {
    const bool any_votes = (v0 + v1) > 0.0f;
    adopt0 = any_votes && (v0 > v1);
    adopt1 = any_votes && (v0 < v1);
  }
  c.coined = c.active && !decide0 && !decide1 && !adopt0 && !adopt1;
  int coin = 0;
  if (__any_sync(kFull, c.coined)) {
    uint32_t pbits, dbits;
    benor::threefry2x32(ck0, ck1, node, trial, &pbits, &dbits);
    coin = (int)(pbits & 1u);
  }
  if (c.active) {
    c.x = decide0 ? kVal0
          : decide1 ? kVal1 : adopt0 ? kVal0 : adopt1 ? kVal1 : coin;
    c.decided = c.decided || decide0 || decide1;
  }
  return c;
}

// The new word of every plane; lane p < P stores plane p.  killed and
// faulty keep their words, down is 0, and k takes rk in the active lanes:
// plane k_b of the word is (old | active) where bit b of rk is set, else
// (old & ~active).  Returns the new decided word.
__device__ __forceinline__ uint32_t store_planes(uint32_t* words, int P,
                                                 size_t stride, int lane,
                                                 const Lane& f,
                                                 const Commit& c, int rk) {
  const uint32_t x0 = __ballot_sync(kFull, c.x & 1);
  const uint32_t x1 = __ballot_sync(kFull, (c.x >> 1) & 1);
  const uint32_t dec = __ballot_sync(kFull, c.decided);
  const uint32_t coi = __ballot_sync(kFull, c.coined);
  const uint32_t act = __ballot_sync(kFull, c.active);
  const int kb = lane >= kPlaneK ? lane - kPlaneK : 0;
  const uint32_t k_new = ((rk >> kb) & 1) ? (f.plane | act)
                                          : (f.plane & ~act);
  const uint32_t w = lane == kPlaneX ? x0
                     : lane == kPlaneX + 1 ? x1
                     : lane == kPlaneDecided ? dec
                     : lane == kPlaneCoined ? coi
                     : lane == kPlaneDown ? 0u
                     : lane >= kPlaneK ? k_new : f.plane;
  if (lane < P) words[lane * stride] = w;
  return dec;
}

// Proposal-pass counts of one lane's warp: the sent-vote histogram over
// live lanes and the alive count.
__device__ __forceinline__ void proposal_counts(int* acc, const Lane& f,
                                                int vote) {
  const uint32_t live = ~f.kil_w;
  const int n0 = __popc(__ballot_sync(kFull, vote == kVal0) & live);
  const int n1 = __popc(__ballot_sync(kFull, vote == kVal1) & live);
  const int alive = __popc(live);
  acc[0] += n0;
  acc[1] += n1;
  acc[2] += alive - n0 - n1;
  acc[3] += alive;
}

// Vote-pass counts of one lane's warp: next round's proposal histogram over
// live lanes, settled and unsettled.
__device__ __forceinline__ void vote_counts(int* acc, const Lane& f,
                                            const Commit& c, uint32_t dec,
                                            int byz) {
  const int s = sent(byz, c.x, f.faulty);
  const uint32_t live = ~f.kil_w;
  const int n0 = __popc(__ballot_sync(kFull, s == kVal0) & live);
  const int n1 = __popc(__ballot_sync(kFull, s == kVal1) & live);
  const int settled = __popc(dec | f.kil_w);
  acc[0] += n0;
  acc[1] += n1;
  acc[2] += __popc(live) - n0 - n1;
  acc[3] += settled;
  acc[4] += kWarp - settled;
}

// Sum per-warp counts over the block: smem[warp][cols] -> out[cols].
template <int kCols>
__device__ __forceinline__ void block_sum(int (*smem)[kCols], int warps,
                                          int* out) {
  __syncthreads();
  if (threadIdx.x < kCols) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += smem[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// grid (blocks, T), 8 warps a block: the blocks of a trial walk its words,
// one warp a word, with a stride of blocks x 8 words.
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocksPerSM)
proposal_hist_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ hist,
                     int* __restrict__ partials, int T, int P, int n_w,
                     uint32_t k0, uint32_t k1, float m, int byz,
                     int freeze) {
  __shared__ benor::CfTrial ct_s;
  __shared__ int smem[kWarpsPerBlock][kPropCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const benor::CfTrial ct = block_cf_trial(
      &ct_s, hist[trial * 3 + 0], hist[trial * 3 + 1], hist[trial * 3 + 2],
      m);
  const size_t stride = (size_t)n_w;
  const uint32_t* tpack = pack + (size_t)trial * P * stride;
  int acc[kPropCols] = {0, 0, 0, 0};
  // a word's planes are loaded one word ahead, so the load overlaps the
  // draws of the word before
  const int step = gridDim.x * kWarpsPerBlock;
  int word = blockIdx.x * kWarpsPerBlock + warp;
  uint32_t plane = load_plane(tpack + word, P, stride, lane, word < n_w);
  for (; word < n_w; word += step) {  // warp-uniform
    const uint32_t next = load_plane(tpack + word + step, P, stride, lane,
                                     word + step < n_w);
    const Lane f = lane_from(plane, lane, freeze);
    const int vote = proposal_vote(f, k0, k1,
                                   (uint32_t)(word * kWarp + lane),
                                   (uint32_t)trial, ct, byz);
    proposal_counts(acc, f, vote);
    plane = next;
  }
  if (lane == 0)
    for (int c = 0; c < kPropCols; ++c) smem[warp][c] = acc[c];
  block_sum<kPropCols>(smem, kWarpsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kPropCols);
}

// grid (blocks, T), 8 warps a block, words walked as in proposal_hist.
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocksPerSM)
vote_commit_kernel(const uint32_t* __restrict__ pack,
                   const float* __restrict__ hist,
                   const int* __restrict__ quorum_ok,
                   uint32_t* __restrict__ new_pack,
                   int* __restrict__ partials, int T, int P, int n_w,
                   uint32_t vk0, uint32_t vk1, uint32_t ck0, uint32_t ck1,
                   int rk, float m, float nf, int textbook, int byz,
                   int freeze) {
  __shared__ benor::CfTrial ct_s;
  __shared__ int smem[kWarpsPerBlock][kVoteCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const benor::CfTrial ct = block_cf_trial(
      &ct_s, hist[trial * 3 + 0], hist[trial * 3 + 1], hist[trial * 3 + 2],
      m);
  const int qok = quorum_ok[trial];
  const size_t stride = (size_t)n_w;
  const size_t tbase = (size_t)trial * P * stride;
  int acc[kVoteCols] = {0, 0, 0, 0, 0};
  const int step = gridDim.x * kWarpsPerBlock;   // loads one word ahead
  int word = blockIdx.x * kWarpsPerBlock + warp;
  uint32_t plane = load_plane(pack + tbase + word, P, stride, lane,
                              word < n_w);
  for (; word < n_w; word += step) {  // warp-uniform
    const uint32_t next = load_plane(pack + tbase + word + step, P, stride,
                                     lane, word + step < n_w);
    const Lane f = lane_from(plane, lane, freeze);
    plane = next;
    const Commit c = vote_lane(f, vk0, vk1, ck0, ck1,
                               (uint32_t)(word * kWarp + lane),
                               (uint32_t)trial, ct, nf, qok, textbook);
    const uint32_t dec = store_planes(new_pack + tbase + word, P, stride,
                                      lane, f, c, rk);
    vote_counts(acc, f, c, dec, byz);
  }
  if (lane == 0)
    for (int c = 0; c < kVoteCols; ++c) smem[warp][c] = acc[c];
  block_sum<kVoteCols>(smem, kWarpsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kVoteCols);
}

// Sum kCols ints over the blocks of the cluster: `blk` is the same
// shared array in each block.  Called by a whole warp after a
// cluster.sync(): lane r < C reads rank r's columns through distributed
// shared memory, and every lane gets the sums (integers, so the order
// moves no bit).
template <int kCols>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            int* blk, int C, int lane,
                                            int* tot) {
  int v[kCols];
  const int* src = cluster.map_shared_rank(blk, lane < C ? lane : 0);
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = lane < C ? src[c] : 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) tot[c] = __reduce_add_sync(kFull, v[c]);
}

// The warp's kept words, one place on: kept[0] is the next word's.
__device__ __forceinline__ void rotate(uint32_t (&kept)[kFusedKeep]) {
  const uint32_t first = kept[0];
#pragma unroll
  for (int k = 0; k + 1 < kFusedKeep; ++k) kept[k] = kept[k + 1];
  kept[kFusedKeep - 1] = first;
}

// One trial's round on a grid of C blocks of W warps a trial (block rank
// = blockIdx.x % C), kCluster = C > 1: the body of fused_round_kernel
// (C = 1, a plain launch) and of fused_cluster_kernel (a cluster of C
// blocks a trial).  Warp g = rank * W + warp of the trial takes words g,
// g + C * W, ... (at most kFusedKeep of them), loads them all before the
// block's proposal terms are computed and keeps them in registers for both
// phases.  Phase 1: proposal tallies.  One block (C = 1) sums its warps'
// counts in shared memory and computes the vote phase's CF terms and
// quorum gate from the sum, as a block of the pair does.  In a cluster
// each block adds its warps' counts into its shared memory; after
// cluster.sync() one warp of every block sums the C blocks' counts through
// distributed shared memory, so every block computes the terms and gate
// from the same integers (rank 0 writes partsA).  Phase 2: vote + commit,
// the tallies summed the same way into partsB (by rank 0), and in a
// cluster a last cluster.sync() so that no block leaves while rank 0 reads
// its shared memory.
template <bool kCluster>
__device__ __forceinline__ void fused_round_body(
    const uint32_t* __restrict__ pack, const float* __restrict__ hist1,
    uint32_t* __restrict__ new_pack, int* __restrict__ parts_a,
    int* __restrict__ parts_b, int P, int n_w, uint32_t pk0, uint32_t pk1,
    uint32_t vk0, uint32_t vk1, uint32_t ck0, uint32_t ck1, int rk, float m,
    float nf, int textbook, int byz, int freeze) {
  __shared__ benor::CfTrial ct_s;
  __shared__ int smem_a[kFusedMaxWarps][kPropCols];
  __shared__ int smem_b[kFusedMaxWarps][kVoteCols];
  __shared__ int tot_a[kPropCols];
  __shared__ int tot_b[kVoteCols];
  __shared__ int qok_s;
  const int C = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int warps = (int)(blockDim.x / kWarp);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = kCluster ? (int)blockIdx.x / C : (int)blockIdx.x;
  const int step = C * warps;
  const int first = rank * warps + warp;
  const size_t stride = (size_t)n_w;
  const size_t tbase = (size_t)trial * P * stride;
  if (kCluster && threadIdx.x < kPropCols) tot_a[threadIdx.x] = 0;
  if (kCluster && threadIdx.x < kVoteCols) tot_b[threadIdx.x] = 0;
  uint32_t kept[kFusedKeep];
#pragma unroll
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    kept[k] = load_plane(pack + tbase + word, P, stride, lane, word < n_w);
  }

  // --- phase 1: proposal tallies -> majority -> vote values -------------
  const benor::CfTrial ct1 = block_cf_trial(
      &ct_s, hist1[trial * 3 + 0], hist1[trial * 3 + 1],
      hist1[trial * 3 + 2], m);
  int acc_a[kPropCols] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    if (word < n_w) {  // warp-uniform
      const Lane f = lane_from(kept[0], lane, freeze);
      const int vote = proposal_vote(f, pk0, pk1,
                                     (uint32_t)(word * kWarp + lane),
                                     (uint32_t)trial, ct1, byz);
      proposal_counts(acc_a, f, vote);
    }
    rotate(kept);
  }

  // --- the vote-phase histogram + quorum gate, whole trial --------------
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    if (lane == 0)
      for (int c = 0; c < kPropCols; ++c) atomicAdd(&tot_a[c], acc_a[c]);
    cluster.sync();
    if (warp == 0) {
      int tot[kPropCols];
      cluster_sum<kPropCols>(cluster, tot_a, C, lane, tot);
      if (lane == 0) {
        ct_s = benor::cf_trial((float)tot[0], (float)tot[1], (float)tot[2],
                               m);
        qok_s = tot[3] >= (int)m ? 1 : 0;
        if (rank == 0)
          for (int c = 0; c < kPropCols; ++c)
            parts_a[trial * kPropCols + c] = tot[c];
      }
    }
    __syncthreads();
  } else {
    if (lane == 0)
      for (int c = 0; c < kPropCols; ++c) smem_a[warp][c] = acc_a[c];
    block_sum<kPropCols>(smem_a, warps, tot_a);
    __syncthreads();
    if (threadIdx.x < kPropCols)
      parts_a[trial * kPropCols + threadIdx.x] = tot_a[threadIdx.x];
    if (threadIdx.x == 0) {
      ct_s = benor::cf_trial((float)tot_a[0], (float)tot_a[1],
                             (float)tot_a[2], m);
      qok_s = tot_a[3] >= (int)m ? 1 : 0;
    }
    __syncthreads();
  }
  const benor::CfTrial ct2 = ct_s;
  const int qok = qok_s;   // n_alive >= quorum

  // --- phase 2: vote tallies -> decide/adopt/coin -> commit -------------
  int acc_b[kVoteCols] = {0, 0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    if (word < n_w) {  // warp-uniform
      const Lane f = lane_from(kept[0], lane, freeze);
      const Commit c = vote_lane(f, vk0, vk1, ck0, ck1,
                                 (uint32_t)(word * kWarp + lane),
                                 (uint32_t)trial, ct2, nf, qok, textbook);
      const uint32_t dec = store_planes(new_pack + tbase + word, P, stride,
                                        lane, f, c, rk);
      vote_counts(acc_b, f, c, dec, byz);
    }
    rotate(kept);
  }
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    if (lane == 0)
      for (int c = 0; c < kVoteCols; ++c) atomicAdd(&tot_b[c], acc_b[c]);
    cluster.sync();
    if (rank == 0 && warp == 0) {
      int tot[kVoteCols];
      cluster_sum<kVoteCols>(cluster, tot_b, C, lane, tot);
      if (lane == 0)
        for (int c = 0; c < kVoteCols; ++c)
          parts_b[trial * kVoteCols + c] = tot[c];
    }
    cluster.sync();
  } else {
    if (lane == 0)
      for (int c = 0; c < kVoteCols; ++c) smem_b[warp][c] = acc_b[c];
    block_sum<kVoteCols>(smem_b, warps, parts_b + trial * kVoteCols);
  }
}

// grid (T) blocks of W warps: one block a trial.
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp, kFusedMinBlocks)
fused_round_kernel(const uint32_t* __restrict__ pack,
                   const float* __restrict__ hist1,
                   uint32_t* __restrict__ new_pack,
                   int* __restrict__ parts_a, int* __restrict__ parts_b,
                   int P, int n_w, uint32_t pk0, uint32_t pk1, uint32_t vk0,
                   uint32_t vk1, uint32_t ck0, uint32_t ck1, int rk, float m,
                   float nf, int textbook, int byz, int freeze) {
  fused_round_body<false>(pack, hist1, new_pack, parts_a, parts_b, P, n_w,
                          pk0, pk1, vk0, vk1, ck0, ck1, rk, m, nf, textbook,
                          byz, freeze);
}

// grid (C x T) blocks of W warps, launched as T clusters of C blocks.
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp, kFusedMinBlocks)
fused_cluster_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ hist1,
                     uint32_t* __restrict__ new_pack,
                     int* __restrict__ parts_a, int* __restrict__ parts_b,
                     int P, int n_w, uint32_t pk0, uint32_t pk1,
                     uint32_t vk0, uint32_t vk1, uint32_t ck0, uint32_t ck1,
                     int rk, float m, float nf, int textbook, int byz,
                     int freeze) {
  fused_round_body<true>(pack, hist1, new_pack, parts_a, parts_b, P, n_w,
                         pk0, pk1, vk0, vk1, ck0, ck1, rk, m, nf, textbook,
                         byz, freeze);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launch (0 = launched).

// Blocks a trial of proposal_hist (kernel 0) or vote_commit (kernel 1) on
// the current device for n_w plane words and T trials -> *blocks: as many
// as fit T times in one wave of the kernel over the card (the SMs times
// the blocks an SM holds), at least one, and never more than a warp a
// word.  Rounding up would put the last few blocks in a second wave of
// their own.  The caller works it out once per shape, sizes the
// [blocks, T, cols] partials from it and passes it to the launcher.
// Returns the first failed query's cudaError (0 = *blocks set).
extern "C" int benor_round_blocks(int kernel, int n_w, int T, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        kernel == 0 ? (const void*)proposal_hist_kernel
                    : (const void*)vote_commit_kernel,
        kWarpsPerBlock * kWarp, 0);
  if (e != cudaSuccess) return (int)e;
  const int word_blocks = (n_w + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int wave = sms * per_sm / T;
  *blocks = wave < 1 ? 1 : (wave < word_blocks ? wave : word_blocks);
  return 0;
}

extern "C" int benor_proposal_hist(const uint32_t* pack, const float* hist,
                                   int* partials, int T, int P, int n_w,
                                   uint32_t k0, uint32_t k1, float m,
                                   int byz, int freeze, int blocks,
                                   cudaStream_t stream) {
  const dim3 grid(blocks, T);
  proposal_hist_kernel<<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(
      pack, hist, partials, T, P, n_w, k0, k1, m, byz, freeze);
  return (int)cudaGetLastError();
}

extern "C" int benor_vote_commit(const uint32_t* pack, const float* hist,
                                 const int* quorum_ok, uint32_t* new_pack,
                                 int* partials, int T, int P, int n_w,
                                 uint32_t vk0, uint32_t vk1, uint32_t ck0,
                                 uint32_t ck1, int rk, float m, float nf,
                                 int textbook, int byz, int freeze,
                                 int blocks, cudaStream_t stream) {
  const dim3 grid(blocks, T);
  vote_commit_kernel<<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(
      pack, hist, quorum_ok, new_pack, partials, T, P, n_w, vk0, vk1, ck0,
      ck1, rk, m, nf, textbook, byz, freeze);
  return (int)cudaGetLastError();
}

// The launch of T clusters of C blocks of `warps` warps of the fused kernel
// on `stream` (T = 1: one cluster, as the occupancy query takes it).  C = 1
// is a plain launch, with no cluster attribute.
static cudaLaunchConfig_t fused_config(int C, int warps, int T,
                                       cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C * T);
  config.blockDim = dim3(warps * kWarp);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = C > 1 ? 1 : 0;
  return config;
}

// True if C blocks of `warps` warps a trial are a grid the fused kernel
// takes for n_w words: C and warps among the choices, every warp with a
// word, no warp with more than kFusedKeep.
static bool fused_dims_ok(int n_w, int C, int warps) {
  bool c_ok = false, w_ok = false;
  for (int c : kFusedClusters) c_ok = c_ok || c == C;
  for (int w : kFusedWarpChoices) w_ok = w_ok || w == warps;
  return c_ok && w_ok && C * warps <= n_w &&
         C * warps * kFusedKeep >= n_w;
}

// Clusters of C blocks of `warps` warps of the fused kernel that the
// current device holds at once -> *clusters (cudaOccupancyMaxActiveClusters
// of fused_round_kernel, a cluster of one block, at C = 1, else of
// fused_cluster_kernel).  For C > 8 it first allows the cluster kernel
// non-portable cluster sizes, which the launch of such a grid needs: the
// wrapper's grid rule (ops/packed_round.py fused_grid) reads these counts
// before its first launch on a device.  Returns the cudaError (0 = set).
extern "C" int benor_fused_fits(int C, int warps, int* clusters) {
  cudaError_t e = cudaSuccess;
  if (C > kPortableCluster)
    e = cudaFuncSetAttribute(fused_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = fused_config(C, warps, 1, 0, &attr);
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters,
      C > 1 ? (const void*)fused_cluster_kernel
            : (const void*)fused_round_kernel,
      &config);
}

// One launch of the fused kernel as T clusters of C blocks of `warps`
// warps (ops/packed_round.py fused_grid's choice): fused_round_kernel at
// C = 1, else fused_cluster_kernel.  A grid it does not take, or a refused
// cluster launch, returns its cudaError: nothing falls back.
extern "C" int benor_fused_round(const uint32_t* pack, const float* hist1,
                                 uint32_t* new_pack, int* parts_a,
                                 int* parts_b, int T, int P, int n_w,
                                 uint32_t pk0, uint32_t pk1, uint32_t vk0,
                                 uint32_t vk1, uint32_t ck0, uint32_t ck1,
                                 int rk, float m, float nf, int textbook,
                                 int byz, int freeze, int C, int warps,
                                 cudaStream_t stream) {
  if (!fused_dims_ok(n_w, C, warps)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(C, warps, T, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &config, C > 1 ? fused_cluster_kernel : fused_round_kernel, pack,
      hist1, new_pack, parts_a, parts_b, P, n_w, pk0, pk1, vk0, vk1, ck0,
      ck1, rk, m, nf, textbook, byz, freeze);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
