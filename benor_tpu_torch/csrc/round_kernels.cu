// The three round kernels of the packed Ben-Or main path, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_round.py:
//   proposal_hist_kernel <- _prop_hist_kernel    (proposal_hist_pallas)
//   vote_commit_kernel   <- _vote_commit_kernel  (vote_commit_pallas)
//   fused_round_kernel   <- _fused_round_kernel  (fused_round_pallas)
// in the 'sampled' counts regime with private coins, crash or byzantine
// faults, either decision rule, freeze on or off.  Their plain torch
// versions live beside the wrappers in ops/packed_round.py.
//
// Layout.  The node state is a [T, P, n_w] stack of 32-bit plane words
// (state.PACK_LAYOUT): plane base + b holds bit b of a field for the 32
// nodes of a word, node id = word * 32 + bit.  One WARP handles one plane
// word: lane L is node word * 32 + L, reads its bits from the word (a
// broadcast load), and the new words are rebuilt with __ballot_sync and
// stored by lane 0.  Per-warp counts are __popc(__ballot_sync(...)), summed
// over the block in shared memory and written as int32 partials
// [blocks, T, cols]; the wrapper sums them over blocks (integer sums, so
// the order moves no bit).  Random draws key on the global (node, trial)
// counters, so the tiling never moves a bit either.
//
// What bounds them.  At N = 1M, T = 32, max_rounds = 64 the stack is
// 14 planes x 31,264 words x 4 B x 32 trials = 56 MB a read, about 17 us at
// 3.35 TB/s.  Every lane runs at least one threefry-2x32-20 block (~120
// integer ops) and two CF draws (each a log, three square roots and ~6
// divides inside ~60 f32 ops): some 300 operations a lane in the proposal
// pass and 420 in the vote pass, against 0.2 bytes a lane.  The kernels are
// bound by ALU and SFU work, not by bytes.  The simple design answers that
// by keeping the arithmetic in registers end to end — nothing per lane
// touches memory but the plane words — and by launching enough warps
// (one per word and trial, ~1M at N = 1M) to fill every SM.  The fused
// kernel runs one block per trial (it needs the whole node axis for the
// vote histogram between its phases), so it fills T SMs only; it serves
// N <= 8192, where the whole round is a few microseconds of work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/_build.py).  No fast-math: the
// kernels must round as torch's elementwise ops do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Plane words (warps) per block on the two-kernel path.  The wrappers size
// the partials buffer from benor_round_blocks(), so this is the only copy.
constexpr int kWordsPerBlock = 8;
// Warps of the fused kernel's one block per trial (512 threads, so the
// launch bound leaves each thread up to 128 registers).
constexpr int kFusedWarps = 16;
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

// One lane's fields, read from its word of every plane.
struct Lane {
  int x, decided, killed, faulty, k;
  bool alive, frozen;
};

__device__ __forceinline__ Lane load_lane(const uint32_t* words, int P,
                                          size_t stride, int lane,
                                          int freeze) {
  Lane f;
  const uint32_t x0 = words[kPlaneX * stride];
  const uint32_t x1 = words[(kPlaneX + 1) * stride];
  f.x = (int)((x0 >> lane) & 1u) | ((int)((x1 >> lane) & 1u) << 1);
  f.decided = (int)((words[kPlaneDecided * stride] >> lane) & 1u);
  f.killed = (int)((words[kPlaneKilled * stride] >> lane) & 1u);
  f.faulty = (int)((words[kPlaneFaulty * stride] >> lane) & 1u);
  int k = 0;
  for (int b = 0; b < P - kPlaneK; ++b)
    k |= (int)((words[(kPlaneK + b) * stride] >> lane) & 1u) << b;
  f.k = k;
  f.alive = f.killed == 0;
  f.frozen = freeze ? (f.decided == 1) : false;
  return f;
}

// Byzantine lanes broadcast bit-flipped values (0 <-> 1, "?" kept).
__device__ __forceinline__ int sent(int byz, int v, int faulty) {
  if (byz && faulty == 1) return v == kVal0 ? kVal1 : (v == kVal1 ? kVal0 : v);
  return v;
}

__device__ __forceinline__ int popc_ballot(bool pred) {
  return __popc(__ballot_sync(kFull, pred));
}

// Proposal phase of one lane -> its sent vote value.
__device__ __forceinline__ int proposal_vote(const Lane& f, uint32_t k0,
                                             uint32_t k1, uint32_t node,
                                             uint32_t trial, float c0,
                                             float c1, float cq, float m,
                                             int byz) {
  float p0, p1;
  benor::cf_pair_draws(k0, k1, node, trial, c0, c1, cq, m, &p0, &p1);
  const int x1 = p0 > p1 ? kVal0 : (p1 > p0 ? kVal1 : kValQ);
  return sent(byz, f.frozen ? f.x : x1, f.faulty);
}

struct Commit {
  int x, decided, k;
  bool coined;
};

// Vote phase of one lane: tallies, coin, decide / adopt / commit
// (pallas_round.py _decide_commit).
__device__ __forceinline__ Commit vote_lane(const Lane& f, uint32_t vk0,
                                            uint32_t vk1, uint32_t ck0,
                                            uint32_t ck1, uint32_t node,
                                            uint32_t trial, float c0,
                                            float c1, float cq, float m,
                                            float nf, int qok, int rk,
                                            int textbook) {
  float v0, v1;
  benor::cf_pair_draws(vk0, vk1, node, trial, c0, c1, cq, m, &v0, &v1);
  uint32_t pbits, dbits;
  benor::threefry2x32(ck0, ck1, node, trial, &pbits, &dbits);
  const int coin = (int)(pbits & 1u);
  const bool decide0 = v0 > nf;
  const bool decide1 = v1 > nf;
  bool no_adopt = true;
  int x2;
  if (!textbook) {
    const bool any_votes = (v0 + v1) > 0.0f;
    const bool adopt0 = any_votes && (v0 > v1);
    const bool adopt1 = any_votes && (v0 < v1);
    no_adopt = !adopt0 && !adopt1;
    x2 = decide0 ? kVal0
                 : decide1 ? kVal1 : adopt0 ? kVal0 : adopt1 ? kVal1 : coin;
  } else {
    x2 = decide0 ? kVal0 : decide1 ? kVal1 : coin;
  }
  const bool active = f.alive && qok != 0 && !f.frozen;
  Commit c;
  c.x = active ? x2 : f.x;
  c.decided = (active && (decide0 || decide1)) ? 1 : f.decided;
  c.k = active ? rk : f.k;
  c.coined = active && !decide0 && !decide1 && no_adopt;
  return c;
}

// Rebuild the lane's word of every plane with ballots; lane 0 stores.
__device__ __forceinline__ void store_planes(uint32_t* out, int P,
                                             size_t stride, int lane,
                                             const Lane& f, const Commit& c) {
  const uint32_t x0 = __ballot_sync(kFull, c.x & 1);
  const uint32_t x1 = __ballot_sync(kFull, (c.x >> 1) & 1);
  const uint32_t dec = __ballot_sync(kFull, c.decided == 1);
  const uint32_t kil = __ballot_sync(kFull, f.killed == 1);
  const uint32_t coi = __ballot_sync(kFull, c.coined);
  const uint32_t fau = __ballot_sync(kFull, f.faulty == 1);
  if (lane == 0) {
    out[kPlaneX * stride] = x0;
    out[(kPlaneX + 1) * stride] = x1;
    out[kPlaneDecided * stride] = dec;
    out[kPlaneKilled * stride] = kil;
    out[kPlaneCoined * stride] = coi;
    out[kPlaneFaulty * stride] = fau;
    out[kPlaneDown * stride] = 0u;
  }
  for (int b = 0; b < P - kPlaneK; ++b) {
    const uint32_t kw = __ballot_sync(kFull, (c.k >> b) & 1);
    if (lane == 0) out[(kPlaneK + b) * stride] = kw;
  }
}

// Vote-pass counts of one lane's warp: next round's proposal histogram over
// live lanes, settled and unsettled.
__device__ __forceinline__ void vote_counts(int* acc, const Lane& f,
                                            const Commit& c, int byz) {
  const int s = sent(byz, c.x, f.faulty);
  const bool settled = c.decided == 1 || f.killed == 1;
  acc[0] += popc_ballot(f.alive && s == kVal0);
  acc[1] += popc_ballot(f.alive && s == kVal1);
  acc[2] += popc_ballot(f.alive && s == kValQ);
  acc[3] += popc_ballot(settled);
  acc[4] += popc_ballot(!settled);
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

// grid (ceil(n_w / 8), T), block 8 warps: one warp per plane word.
__global__ void __launch_bounds__(kWordsPerBlock * kWarp)
proposal_hist_kernel(const uint32_t* __restrict__ pack,
                                     const float* __restrict__ hist,
                                     int* __restrict__ partials, int T,
                                     int P, int n_w, uint32_t k0,
                                     uint32_t k1, float m, int byz,
                                     int freeze) {
  __shared__ int smem[kWordsPerBlock][kPropCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const int word = blockIdx.x * kWordsPerBlock + warp;
  int acc[kPropCols] = {0, 0, 0, 0};
  if (word < n_w) {  // warp-uniform
    const size_t stride = (size_t)n_w;
    const uint32_t* words = pack + (size_t)trial * P * stride + word;
    const Lane f = load_lane(words, P, stride, lane, freeze);
    const int vote = proposal_vote(
        f, k0, k1, (uint32_t)(word * kWarp + lane), (uint32_t)trial,
        hist[trial * 3 + 0], hist[trial * 3 + 1], hist[trial * 3 + 2], m,
        byz);
    acc[0] = popc_ballot(f.alive && vote == kVal0);
    acc[1] = popc_ballot(f.alive && vote == kVal1);
    acc[2] = popc_ballot(f.alive && vote == kValQ);
    acc[3] = popc_ballot(f.alive);
  }
  if (lane == 0)
    for (int c = 0; c < kPropCols; ++c) smem[warp][c] = acc[c];
  block_sum<kPropCols>(smem, kWordsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kPropCols);
}

// grid (ceil(n_w / 8), T), block 8 warps: one warp per plane word.
__global__ void __launch_bounds__(kWordsPerBlock * kWarp)
vote_commit_kernel(const uint32_t* __restrict__ pack,
                                   const float* __restrict__ hist,
                                   const int* __restrict__ quorum_ok,
                                   uint32_t* __restrict__ new_pack,
                                   int* __restrict__ partials, int T, int P,
                                   int n_w, uint32_t vk0, uint32_t vk1,
                                   uint32_t ck0, uint32_t ck1, int rk,
                                   float m, float nf, int textbook, int byz,
                                   int freeze) {
  __shared__ int smem[kWordsPerBlock][kVoteCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const int word = blockIdx.x * kWordsPerBlock + warp;
  int acc[kVoteCols] = {0, 0, 0, 0, 0};
  if (word < n_w) {  // warp-uniform
    const size_t stride = (size_t)n_w;
    const size_t base = (size_t)trial * P * stride + word;
    const Lane f = load_lane(pack + base, P, stride, lane, freeze);
    const Commit c = vote_lane(
        f, vk0, vk1, ck0, ck1, (uint32_t)(word * kWarp + lane),
        (uint32_t)trial, hist[trial * 3 + 0], hist[trial * 3 + 1],
        hist[trial * 3 + 2], m, nf, quorum_ok[trial], rk, textbook);
    store_planes(new_pack + base, P, stride, lane, f, c);
    vote_counts(acc, f, c, byz);
  }
  if (lane == 0)
    for (int c = 0; c < kVoteCols; ++c) smem[warp][c] = acc[c];
  block_sum<kVoteCols>(smem, kWordsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kVoteCols);
}

// grid (T), block 16 warps: one block walks its trial's n_w <= 256 words
// twice — the proposal pass, the whole-axis vote histogram and quorum gate
// in shared memory, then the vote pass + commit.
__global__ void __launch_bounds__(kFusedWarps * kWarp)
fused_round_kernel(const uint32_t* __restrict__ pack,
                                   const float* __restrict__ hist1,
                                   uint32_t* __restrict__ new_pack,
                                   int* __restrict__ parts_a,
                                   int* __restrict__ parts_b, int T, int P,
                                   int n_w, uint32_t pk0, uint32_t pk1,
                                   uint32_t vk0, uint32_t vk1, uint32_t ck0,
                                   uint32_t ck1, int rk, float m, float nf,
                                   int textbook, int byz, int freeze) {
  __shared__ int smem_a[kFusedWarps][kPropCols];
  __shared__ int smem_b[kFusedWarps][kVoteCols];
  __shared__ int tot_a[kPropCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.x;
  const size_t stride = (size_t)n_w;
  const size_t tbase = (size_t)trial * P * stride;

  // --- phase 1: proposal tallies -> majority -> vote values -------------
  const float c0 = hist1[trial * 3 + 0];
  const float c1 = hist1[trial * 3 + 1];
  const float cq = hist1[trial * 3 + 2];
  int acc_a[kPropCols] = {0, 0, 0, 0};
  for (int word = warp; word < n_w; word += kFusedWarps) {
    const Lane f = load_lane(pack + tbase + word, P, stride, lane, freeze);
    const int vote = proposal_vote(f, pk0, pk1,
                                   (uint32_t)(word * kWarp + lane),
                                   (uint32_t)trial, c0, c1, cq, m, byz);
    acc_a[0] += popc_ballot(f.alive && vote == kVal0);
    acc_a[1] += popc_ballot(f.alive && vote == kVal1);
    acc_a[2] += popc_ballot(f.alive && vote == kValQ);
    acc_a[3] += popc_ballot(f.alive);
  }
  if (lane == 0)
    for (int c = 0; c < kPropCols; ++c) smem_a[warp][c] = acc_a[c];
  block_sum<kPropCols>(smem_a, kFusedWarps, tot_a);
  __syncthreads();
  if (threadIdx.x < kPropCols)
    parts_a[trial * kPropCols + threadIdx.x] = tot_a[threadIdx.x];

  // --- the vote-phase global histogram + quorum gate, whole-axis --------
  const float v_c0 = (float)tot_a[0];
  const float v_c1 = (float)tot_a[1];
  const float v_cq = (float)tot_a[2];
  const int qok = tot_a[3] >= (int)m ? 1 : 0;   // n_alive >= quorum

  // --- phase 2: vote tallies -> decide/adopt/coin -> commit -------------
  int acc_b[kVoteCols] = {0, 0, 0, 0, 0};
  for (int word = warp; word < n_w; word += kFusedWarps) {
    const Lane f = load_lane(pack + tbase + word, P, stride, lane, freeze);
    const Commit c = vote_lane(f, vk0, vk1, ck0, ck1,
                               (uint32_t)(word * kWarp + lane),
                               (uint32_t)trial, v_c0, v_c1, v_cq, m, nf, qok,
                               rk, textbook);
    store_planes(new_pack + tbase + word, P, stride, lane, f, c);
    vote_counts(acc_b, f, c, byz);
  }
  if (lane == 0)
    for (int c = 0; c < kVoteCols; ++c) smem_b[warp][c] = acc_b[c];
  block_sum<kVoteCols>(smem_b, kFusedWarps, parts_b + trial * kVoteCols);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launch (0 = launched).

// Word-blocks of the two-kernel path for n_w plane words: the leading axis
// of the [blocks, T, cols] partials the caller allocates.
extern "C" int benor_round_blocks(int n_w) {
  return (n_w + kWordsPerBlock - 1) / kWordsPerBlock;
}

extern "C" int benor_proposal_hist(const uint32_t* pack, const float* hist,
                                   int* partials, int T, int P, int n_w,
                                   uint32_t k0, uint32_t k1, float m,
                                   int byz, int freeze,
                                   cudaStream_t stream) {
  const dim3 grid(benor_round_blocks(n_w), T);
  proposal_hist_kernel<<<grid, kWordsPerBlock * kWarp, 0, stream>>>(
      pack, hist, partials, T, P, n_w, k0, k1, m, byz, freeze);
  return (int)cudaGetLastError();
}

extern "C" int benor_vote_commit(const uint32_t* pack, const float* hist,
                                 const int* quorum_ok, uint32_t* new_pack,
                                 int* partials, int T, int P, int n_w,
                                 uint32_t vk0, uint32_t vk1, uint32_t ck0,
                                 uint32_t ck1, int rk, float m, float nf,
                                 int textbook, int byz, int freeze,
                                 cudaStream_t stream) {
  const dim3 grid(benor_round_blocks(n_w), T);
  vote_commit_kernel<<<grid, kWordsPerBlock * kWarp, 0, stream>>>(
      pack, hist, quorum_ok, new_pack, partials, T, P, n_w, vk0, vk1, ck0,
      ck1, rk, m, nf, textbook, byz, freeze);
  return (int)cudaGetLastError();
}

extern "C" int benor_fused_round(const uint32_t* pack, const float* hist1,
                                 uint32_t* new_pack, int* parts_a,
                                 int* parts_b, int T, int P, int n_w,
                                 uint32_t pk0, uint32_t pk1, uint32_t vk0,
                                 uint32_t vk1, uint32_t ck0, uint32_t ck1,
                                 int rk, float m, float nf, int textbook,
                                 int byz, int freeze, cudaStream_t stream) {
  fused_round_kernel<<<T, kFusedWarps * kWarp, 0, stream>>>(
      pack, hist1, new_pack, parts_a, parts_b, T, P, n_w, pk0, pk1, vk0, vk1,
      ck0, ck1, rk, m, nf, textbook, byz, freeze);
  return (int)cudaGetLastError();
}
