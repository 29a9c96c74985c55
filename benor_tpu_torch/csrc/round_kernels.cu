// The three round kernels of the packed Ben-Or main path, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_round.py:
//   proposal_hist_kernel <- _prop_hist_kernel    (proposal_hist_pallas)
//   vote_commit_kernel   <- _vote_commit_kernel  (vote_commit_pallas)
//   fused_round_kernel   <- _fused_round_kernel  (fused_round_pallas),
//   fused_cluster_kernel    its cluster form (the same body)
// in every counts regime, coin and fault model the JAX package's packed
// round serves but crash_at_round / crash_recover: either decision rule,
// freeze on or off.  Their plain torch versions live beside the wrappers in
// ops/packed_round.py.
//
// Modes.  Each body is a template over the modes that change its per-lane
// work, each combination the JAX package can reach built once (the
// ``extern "C"`` entries pick the instantiation; a combination that is not
// built is refused):
//  - CountsMode (tally.pallas_round_counts_mode): kSampled draws a lane's
//    tallies in-kernel from the phase's class histogram (the CF pair, or
//    with kEquivDraws the equivocate regime's mixed-population tally,
//    pallas_round.py _mixed_draws); kDelivered broadcasts the adversarial
//    scheduler's per-trial closed-form counts; kCamps picks the targeted
//    adversary's camp triple by the lane's global node id against the
//    camp bounds (_camp_select).  The closed forms draw nothing;
//  - CoinMode (_decide_commit): kPrivate, bit 0 of the coin stream's
//    threefry word 0; kCommon, the trial's shared bit (no threefry);
//    kWeak, the private bit where the uniform of word 1 is below eps,
//    else the shared bit;
//  - Pop, the population the vote histograms count: kAllLive, every live
//    lane; kHonestLive, the live lanes less the equivocators (their values
//    are drawn receiver-side or chosen by the adversary), while the alive
//    count keeps them; kEquivDraws, the honest live lanes plus the
//    equivocate regime's draws (sampled counts only).  The fused kernel,
//    sampled only, takes it as ``bool kEquiv``;
//  - ``byz`` stays a runtime flag: it flips the byzantine lanes' sent
//    values.
// The fused kernel serves sampled counts only (kSampled x CoinMode x
// kEquiv); delivered and camps rounds always take the pair.  The
// instantiations <kSampled, kPrivate, kAllLive> and <kPrivate, false> are
// the main path's, as they were before the modes came in.
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
// The equivocate draws' instantiations hold the trial's EquivTrial (24
// floats) and two threefry blocks a lane: at 64 registers they spilled,
// so their bound is 3 blocks an SM (85 registers a thread), and the fused
// kernel's one block of 16 warps (128).
constexpr int kMinBlocksEquiv = 3;
constexpr int kFusedMinBlocksEquiv = 1;
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
// CountsMode and CoinMode (ops/packed_round.py COUNTS_MODES, COIN_MODES).
constexpr int kSampled = 0, kDelivered = 1, kCamps = 2;
constexpr int kPrivate = 0, kCommon = 1, kWeak = 2;
// Pop: the vote histograms' population, and the equivocate draws.
constexpr int kAllLive = 0, kHonestLive = 1, kEquivDraws = 2;
// Count operand floats a trial, by counts mode (ops/packed_round.py
// kernel_vecs): the class histogram (c0, c1, cq); the delivered (v0, v1);
// the camp triples' value counts, camp-major (0-camp, 1-camp, "?"-camp).
template <int kCounts>
constexpr int kVecs = kCounts == kSampled ? 3 : kCounts == kDelivered ? 2 : 6;

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

// The word's lanes the vote histograms count: the live lanes, less the
// equivocators where kHonest (pallas_round.py _honest).
template <bool kHonest>
__device__ __forceinline__ uint32_t honest_word(const Lane& f) {
  if constexpr (kHonest) return ~f.kil_w & ~f.fau_w;
  return ~f.kil_w;
}

// A phase's stream keys (the phase's, and the equivocate draws' second
// stream at phase + 64) and the targeted adversary's camp bounds (the first
// global node id of the 0-camp and of the 1-camp).
struct Draw {
  uint32_t k0, k1, k20, k21, b0, b1;
};

// A phase's per-trial terms, by counts mode: the CF pair's or the
// equivocate tally's (sampled), else the trial's closed-form counts.
template <int kCounts, bool kEquiv>
struct TrialTerms {
  float v[kVecs<kCounts>];
};
template <>
struct TrialTerms<kSampled, false> {
  benor::CfTrial ct;
};
template <>
struct TrialTerms<kSampled, true> {
  benor::EquivTrial et;
};

// The sampled terms from a phase's class histogram (c0, c1, cq), the
// trial's live equivocators ``ne`` (read under kEquiv only) and the quorum.
template <bool kEquiv>
__device__ __forceinline__ TrialTerms<kSampled, kEquiv> sampled_terms(
    float c0, float c1, float cq, const float* ne, float m) {
  TrialTerms<kSampled, kEquiv> t;
  if constexpr (kEquiv)
    t.et = benor::equiv_trial(c0, c1, cq, *ne, m);
  else
    t.ct = benor::cf_trial(c0, c1, cq, m);
  return t;
}

// One thread of the block computes its trial's terms from the count
// operand into shared memory; every thread then copies them.  Holds a
// __syncthreads.
template <int kCounts, bool kEquiv>
__device__ __forceinline__ TrialTerms<kCounts, kEquiv> block_terms(
    TrialTerms<kCounts, kEquiv>* smem, const float* counts,
    const float* n_equiv, int trial, float m) {
  const float* c = counts + trial * kVecs<kCounts>;
  if constexpr (kCounts == kSampled) {
    if (threadIdx.x == 0)
      *smem = sampled_terms<kEquiv>(c[0], c[1], c[2], n_equiv + trial, m);
  } else {
    if (threadIdx.x < kVecs<kCounts>) smem->v[threadIdx.x] = c[threadIdx.x];
  }
  __syncthreads();
  return *smem;
}

// A lane's two tallies (class 0, class 1) of a phase: drawn (sampled), the
// trial's counts (delivered), or its camp's counts by node id (camps).
template <int kCounts, bool kEquiv>
__device__ __forceinline__ void lane_tally(
    const TrialTerms<kCounts, kEquiv>& tt, const Draw& d, uint32_t node,
    uint32_t trial, float* a, float* b) {
  if constexpr (kCounts == kDelivered) {
    *a = tt.v[0];
    *b = tt.v[1];
  } else if constexpr (kCounts == kCamps) {
    const bool in1 = node >= d.b1;
    const bool in0 = node >= d.b0 && !in1;
    *a = in1 ? tt.v[2] : (in0 ? tt.v[0] : tt.v[4]);
    *b = in1 ? tt.v[3] : (in0 ? tt.v[1] : tt.v[5]);
  } else if constexpr (kEquiv) {
    uint32_t b0, b1, b2, b3;
    benor::threefry2x32(d.k0, d.k1, node, trial, &b0, &b1);
    benor::threefry2x32(d.k20, d.k21, node, trial, &b2, &b3);
    float nq;
    benor::equiv_draws(tt.et, benor::bits_to_uniform(b0),
                       benor::bits_to_uniform(b1), benor::bits_to_uniform(b2),
                       benor::bits_to_uniform(b3), a, b, &nq);
  } else {
    benor::cf_pair(d.k0, d.k1, node, trial, tt.ct, a, b);
  }
}

// Proposal phase of one lane -> its sent vote value.  The tallies are
// drawn only in warps with a lane alive and not frozen: a frozen lane sends
// its x and a dead lane is not counted, so no skipped draw is ever read.
template <int kCounts, bool kEquiv>
__device__ __forceinline__ int proposal_vote(
    const Lane& f, const Draw& d, uint32_t node, uint32_t trial,
    const TrialTerms<kCounts, kEquiv>& tt, int byz) {
  int x1 = f.x;
  if (__any_sync(kFull, f.alive && !f.frozen)) {
    float p0, p1;
    lane_tally(tt, d, node, trial, &p0, &p1);
    x1 = p0 > p1 ? kVal0 : (p1 > p0 ? kVal1 : kValQ);
  }
  return sent(byz, f.frozen ? f.x : x1, f.faulty);
}

struct Commit {
  int x;
  bool decided, coined, active;
};

// Vote phase of one lane: tallies, coin, decide / adopt / commit
// (pallas_round.py _decide_commit).  The tallies are drawn only in warps
// with an active lane (alive, quorum met, not frozen), and the coin's
// threefry block only in warps with an active lane that neither decides
// nor adopts: every other lane keeps its fields, so no skipped value is
// ever read.  The common coin is the trial's ``shared`` bit and draws
// nothing; the weak coin takes the private bit where word 1's uniform is
// below ``eps``, else ``shared``.
template <int kCounts, int kCoin, bool kEquiv>
__device__ __forceinline__ Commit vote_lane(
    const Lane& f, const Draw& d, uint32_t ck0, uint32_t ck1, uint32_t node,
    uint32_t trial, const TrialTerms<kCounts, kEquiv>& tt, float nf, int qok,
    int textbook, int shared, float eps) {
  Commit c{f.x, f.decided, false, f.alive && qok != 0 && !f.frozen};
  if (!__any_sync(kFull, c.active)) return c;
  float v0, v1;
  lane_tally(tt, d, node, trial, &v0, &v1);
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
  if constexpr (kCoin == kCommon) {
    coin = shared;
  } else if (__any_sync(kFull, c.coined)) {
    uint32_t pbits, dbits;
    benor::threefry2x32(ck0, ck1, node, trial, &pbits, &dbits);
    coin = (int)(pbits & 1u);
    if constexpr (kCoin == kWeak)
      coin = benor::bits_to_uniform(dbits) < eps ? coin : shared;
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
// the histograms' lanes and the alive count (equivocators included).
template <bool kHonest>
__device__ __forceinline__ void proposal_counts(int* acc, const Lane& f,
                                                int vote) {
  const uint32_t hon = honest_word<kHonest>(f);
  const int n0 = __popc(__ballot_sync(kFull, vote == kVal0) & hon);
  const int n1 = __popc(__ballot_sync(kFull, vote == kVal1) & hon);
  const int alive = __popc(~f.kil_w);
  acc[0] += n0;
  acc[1] += n1;
  acc[2] += (kHonest ? __popc(hon) : alive) - n0 - n1;
  acc[3] += alive;
}

// Vote-pass counts of one lane's warp: next round's proposal histogram over
// the histograms' lanes, settled and unsettled.
template <bool kHonest>
__device__ __forceinline__ void vote_counts(int* acc, const Lane& f,
                                            const Commit& c, uint32_t dec,
                                            int byz) {
  const int s = sent(byz, c.x, f.faulty);
  const uint32_t hon = honest_word<kHonest>(f);
  const int n0 = __popc(__ballot_sync(kFull, s == kVal0) & hon);
  const int n1 = __popc(__ballot_sync(kFull, s == kVal1) & hon);
  const int settled = __popc(dec | f.kil_w);
  acc[0] += n0;
  acc[1] += n1;
  acc[2] += __popc(hon) - n0 - n1;
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
// one warp a word, with a stride of blocks x 8 words.  ``counts``: the
// phase's count operand, kVecs floats a trial; ``n_equiv``: live
// equivocators a trial (kEquivDraws only).
template <int kCounts, int kPop>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  kPop == kEquivDraws ? kMinBlocksEquiv
                                                      : kMinBlocksPerSM)
proposal_hist_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ counts,
                     const float* __restrict__ n_equiv,
                     int* __restrict__ partials, int T, int P, int n_w,
                     Draw d, float m, int byz, int freeze) {
  constexpr bool kEquiv = kPop == kEquivDraws;
  __shared__ TrialTerms<kCounts, kEquiv> tt_s;
  __shared__ int smem[kWarpsPerBlock][kPropCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const TrialTerms<kCounts, kEquiv> tt =
      block_terms(&tt_s, counts, n_equiv, trial, m);
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
    const int vote = proposal_vote(f, d, (uint32_t)(word * kWarp + lane),
                                   (uint32_t)trial, tt, byz);
    proposal_counts<kPop != kAllLive>(acc, f, vote);
    plane = next;
  }
  if (lane == 0)
    for (int c = 0; c < kPropCols; ++c) smem[warp][c] = acc[c];
  block_sum<kPropCols>(smem, kWarpsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kPropCols);
}

// grid (blocks, T), 8 warps a block, words walked as in proposal_hist.
// ``shared``: the trial's shared coin bit (common and weak coins only).
template <int kCounts, int kCoin, int kPop>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  kPop == kEquivDraws ? kMinBlocksEquiv
                                                      : kMinBlocksPerSM)
vote_commit_kernel(const uint32_t* __restrict__ pack,
                   const float* __restrict__ counts,
                   const float* __restrict__ n_equiv,
                   const int* __restrict__ quorum_ok,
                   const int* __restrict__ shared,
                   uint32_t* __restrict__ new_pack,
                   int* __restrict__ partials, int T, int P, int n_w, Draw d,
                   uint32_t ck0, uint32_t ck1, int rk, float m, float nf,
                   float eps, int textbook, int byz, int freeze) {
  constexpr bool kEquiv = kPop == kEquivDraws;
  __shared__ TrialTerms<kCounts, kEquiv> tt_s;
  __shared__ int smem[kWarpsPerBlock][kVoteCols];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int trial = blockIdx.y;
  const TrialTerms<kCounts, kEquiv> tt =
      block_terms(&tt_s, counts, n_equiv, trial, m);
  const int qok = quorum_ok[trial];
  int shared_bit = 0;
  if constexpr (kCoin != kPrivate) shared_bit = shared[trial];
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
    const Commit c = vote_lane<kCounts, kCoin, kEquiv>(
        f, d, ck0, ck1, (uint32_t)(word * kWarp + lane), (uint32_t)trial,
        tt, nf, qok, textbook, shared_bit, eps);
    const uint32_t dec = store_planes(new_pack + tbase + word, P, stride,
                                      lane, f, c, rk);
    vote_counts<kPop != kAllLive>(acc, f, c, dec, byz);
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
// counts in shared memory and computes the vote phase's terms and
// quorum gate from the sum, as a block of the pair does.  In a cluster
// each block adds its warps' counts into its shared memory; after
// cluster.sync() one warp of every block sums the C blocks' counts through
// distributed shared memory, so every block computes the terms and gate
// from the same integers (rank 0 writes partsA).  Phase 2: vote + commit,
// the tallies summed the same way into partsB (by rank 0), and in a
// cluster a last cluster.sync() so that no block leaves while rank 0 reads
// its shared memory.  Sampled counts only: the histograms count the honest
// live lanes exactly where kEquiv.
template <bool kCluster, int kCoin, bool kEquiv>
__device__ __forceinline__ void fused_round_body(
    const uint32_t* __restrict__ pack, const float* __restrict__ hist1,
    const float* __restrict__ n_equiv, const int* __restrict__ shared,
    uint32_t* __restrict__ new_pack, int* __restrict__ parts_a,
    int* __restrict__ parts_b, int P, int n_w, const Draw& pd,
    const Draw& vd, uint32_t ck0, uint32_t ck1, int rk, float m, float nf,
    float eps, int textbook, int byz, int freeze) {
  __shared__ TrialTerms<kSampled, kEquiv> tt_s;
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
  const TrialTerms<kSampled, kEquiv> tt1 =
      block_terms(&tt_s, hist1, n_equiv, trial, m);
  int acc_a[kPropCols] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    if (word < n_w) {  // warp-uniform
      const Lane f = lane_from(kept[0], lane, freeze);
      const int vote = proposal_vote(f, pd, (uint32_t)(word * kWarp + lane),
                                     (uint32_t)trial, tt1, byz);
      proposal_counts<kEquiv>(acc_a, f, vote);
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
        tt_s = sampled_terms<kEquiv>((float)tot[0], (float)tot[1],
                                     (float)tot[2], n_equiv + trial, m);
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
      tt_s = sampled_terms<kEquiv>((float)tot_a[0], (float)tot_a[1],
                                   (float)tot_a[2], n_equiv + trial, m);
      qok_s = tot_a[3] >= (int)m ? 1 : 0;
    }
    __syncthreads();
  }
  const TrialTerms<kSampled, kEquiv> tt2 = tt_s;
  const int qok = qok_s;   // n_alive >= quorum
  int shared_bit = 0;
  if constexpr (kCoin != kPrivate) shared_bit = shared[trial];

  // --- phase 2: vote tallies -> decide/adopt/coin -> commit -------------
  int acc_b[kVoteCols] = {0, 0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    if (word < n_w) {  // warp-uniform
      const Lane f = lane_from(kept[0], lane, freeze);
      const Commit c = vote_lane<kSampled, kCoin, kEquiv>(
          f, vd, ck0, ck1, (uint32_t)(word * kWarp + lane), (uint32_t)trial,
          tt2, nf, qok, textbook, shared_bit, eps);
      const uint32_t dec = store_planes(new_pack + tbase + word, P, stride,
                                        lane, f, c, rk);
      vote_counts<kEquiv>(acc_b, f, c, dec, byz);
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
template <int kCoin, bool kEquiv>
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp,
                                  kEquiv ? kFusedMinBlocksEquiv
                                         : kFusedMinBlocks)
fused_round_kernel(const uint32_t* __restrict__ pack,
                   const float* __restrict__ hist1,
                   const float* __restrict__ n_equiv,
                   const int* __restrict__ shared,
                   uint32_t* __restrict__ new_pack,
                   int* __restrict__ parts_a, int* __restrict__ parts_b,
                   int P, int n_w, Draw pd, Draw vd, uint32_t ck0,
                   uint32_t ck1, int rk, float m, float nf, float eps,
                   int textbook, int byz, int freeze) {
  fused_round_body<false, kCoin, kEquiv>(
      pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b, P, n_w, pd,
      vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze);
}

// grid (C x T) blocks of W warps, launched as T clusters of C blocks.
template <int kCoin, bool kEquiv>
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp,
                                  kEquiv ? kFusedMinBlocksEquiv
                                         : kFusedMinBlocks)
fused_cluster_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ hist1,
                     const float* __restrict__ n_equiv,
                     const int* __restrict__ shared,
                     uint32_t* __restrict__ new_pack,
                     int* __restrict__ parts_a, int* __restrict__ parts_b,
                     int P, int n_w, Draw pd, Draw vd, uint32_t ck0,
                     uint32_t ck1, int rk, float m, float nf, float eps,
                     int textbook, int byz, int freeze) {
  fused_round_body<true, kCoin, kEquiv>(
      pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b, P, n_w, pd,
      vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze);
}

// The instantiations the JAX package's dispatch can reach, by mode (nullptr
// for any other combination).
using ProposalFn = void (*)(const uint32_t*, const float*, const float*,
                            int*, int, int, int, Draw, float, int, int);
using VoteFn = void (*)(const uint32_t*, const float*, const float*,
                        const int*, const int*, uint32_t*, int*, int, int,
                        int, Draw, uint32_t, uint32_t, int, float, float,
                        float, int, int, int);
using FusedFn = void (*)(const uint32_t*, const float*, const float*,
                         const int*, uint32_t*, int*, int*, int, int, Draw,
                         Draw, uint32_t, uint32_t, int, float, float, float,
                         int, int, int);

// The launch's Pop from the C interface's flags (-1: none).  Sampled
// counts under equivocate always draw (equiv), the closed forms never.
int pop_of(int counts, int equiv, int honest) {
  if (counts == kSampled) return equiv != honest ? -1 : equiv ? kEquivDraws
                                                              : kAllLive;
  return equiv ? -1 : honest ? kHonestLive : kAllLive;
}

template <int kCounts>
ProposalFn proposal_fn_pop(int pop) {
  switch (pop) {
    case kAllLive: return proposal_hist_kernel<kCounts, kAllLive>;
    case kHonestLive:
      if constexpr (kCounts == kSampled) return nullptr;
      else return proposal_hist_kernel<kCounts, kHonestLive>;
    case kEquivDraws:
      if constexpr (kCounts != kSampled) return nullptr;
      else return proposal_hist_kernel<kCounts, kEquivDraws>;
  }
  return nullptr;
}

ProposalFn proposal_fn(int counts, int equiv, int honest) {
  const int pop = pop_of(counts, equiv, honest);
  switch (counts) {
    case kSampled: return proposal_fn_pop<kSampled>(pop);
    case kDelivered: return proposal_fn_pop<kDelivered>(pop);
    case kCamps: return proposal_fn_pop<kCamps>(pop);
  }
  return nullptr;
}

template <int kCounts, int kPop>
VoteFn vote_fn_coin(int coin) {
  switch (coin) {
    case kPrivate: return vote_commit_kernel<kCounts, kPrivate, kPop>;
    case kCommon: return vote_commit_kernel<kCounts, kCommon, kPop>;
    case kWeak: return vote_commit_kernel<kCounts, kWeak, kPop>;
  }
  return nullptr;
}

template <int kCounts>
VoteFn vote_fn_pop(int coin, int pop) {
  switch (pop) {
    case kAllLive: return vote_fn_coin<kCounts, kAllLive>(coin);
    case kHonestLive:
      if constexpr (kCounts == kSampled) return nullptr;
      else return vote_fn_coin<kCounts, kHonestLive>(coin);
    case kEquivDraws:
      if constexpr (kCounts != kSampled) return nullptr;
      else return vote_fn_coin<kCounts, kEquivDraws>(coin);
  }
  return nullptr;
}

VoteFn vote_fn(int counts, int coin, int equiv, int honest) {
  const int pop = pop_of(counts, equiv, honest);
  switch (counts) {
    case kSampled: return vote_fn_pop<kSampled>(coin, pop);
    case kDelivered: return vote_fn_pop<kDelivered>(coin, pop);
    case kCamps: return vote_fn_pop<kCamps>(coin, pop);
  }
  return nullptr;
}

template <bool kEquiv>
FusedFn fused_fn_coin(bool cluster, int coin) {
  switch (coin) {
    case kPrivate:
      return cluster ? fused_cluster_kernel<kPrivate, kEquiv>
                     : fused_round_kernel<kPrivate, kEquiv>;
    case kCommon:
      return cluster ? fused_cluster_kernel<kCommon, kEquiv>
                     : fused_round_kernel<kCommon, kEquiv>;
    case kWeak:
      return cluster ? fused_cluster_kernel<kWeak, kEquiv>
                     : fused_round_kernel<kWeak, kEquiv>;
  }
  return nullptr;
}

FusedFn fused_fn(bool cluster, int coin, int equiv) {
  return equiv ? fused_fn_coin<true>(cluster, coin)
               : fused_fn_coin<false>(cluster, coin);
}

// A plain launch of `blocks` x T blocks of the pair's width on `stream`.
cudaLaunchConfig_t pair_config(int blocks, int T, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, T);
  config.blockDim = dim3(kWarpsPerBlock * kWarp);
  config.stream = stream;
  return config;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after its launch (0 = launched); a mode combination
// that is not built returns cudaErrorInvalidValue and launches nothing.
// Modes: counts 0 sampled, 1 delivered, 2 camps; coin 0 private, 1 common,
// 2 weak; equiv 1 for the equivocate draws (sampled only); honest 1 where
// the vote histograms leave the equivocators out (fault model
// 'equivocate': with sampled counts exactly where equiv).

// Blocks a trial of proposal_hist (kernel 0) or vote_commit (kernel 1) in
// the given modes on the current device for n_w plane words and T trials
// -> *blocks: as many as fit T times in one wave of the kernel over the
// card (the SMs times the blocks an SM holds), at least one, and never more
// than a warp a word.  Rounding up would put the last few blocks in a
// second wave of their own.  The caller works it out once per shape and
// modes, sizes the [blocks, T, cols] partials from it and passes it to the
// launcher.  Returns the first failed query's cudaError (0 = *blocks set).
extern "C" int benor_round_blocks(int kernel, int counts, int coin,
                                  int equiv, int honest, int n_w, int T,
                                  int* blocks) {
  const void* fn =
      kernel == 0 ? (const void*)proposal_fn(counts, equiv, honest)
                  : (const void*)vote_fn(counts, coin, equiv, honest);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kWarpsPerBlock * kWarp, 0);
  if (e != cudaSuccess) return (int)e;
  const int word_blocks = (n_w + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int wave = sms * per_sm / T;
  *blocks = wave < 1 ? 1 : (wave < word_blocks ? wave : word_blocks);
  return 0;
}

extern "C" int benor_proposal_hist(const uint32_t* pack, const float* counts,
                                   const float* n_equiv, int* partials,
                                   int T, int P, int n_w, uint32_t k0,
                                   uint32_t k1, uint32_t k20, uint32_t k21,
                                   uint32_t camp_b0, uint32_t camp_b1,
                                   float m, int counts_mode, int equiv,
                                   int byz, int honest, int freeze,
                                   int blocks, cudaStream_t stream) {
  const ProposalFn fn = proposal_fn(counts_mode, equiv, honest);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t config = pair_config(blocks, T, stream);
  const Draw d{k0, k1, k20, k21, camp_b0, camp_b1};
  const cudaError_t e = cudaLaunchKernelEx(&config, fn, pack, counts,
                                           n_equiv, partials, T, P, n_w, d,
                                           m, byz, freeze);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int benor_vote_commit(const uint32_t* pack, const float* counts,
                                 const float* n_equiv, const int* quorum_ok,
                                 const int* shared, uint32_t* new_pack,
                                 int* partials, int T, int P, int n_w,
                                 uint32_t vk0, uint32_t vk1, uint32_t vk20,
                                 uint32_t vk21, uint32_t ck0, uint32_t ck1,
                                 uint32_t camp_b0, uint32_t camp_b1, int rk,
                                 float m, float nf, float eps,
                                 int counts_mode, int coin_mode, int equiv,
                                 int textbook, int byz, int honest,
                                 int freeze, int blocks,
                                 cudaStream_t stream) {
  const VoteFn fn = vote_fn(counts_mode, coin_mode, equiv, honest);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t config = pair_config(blocks, T, stream);
  const Draw d{vk0, vk1, vk20, vk21, camp_b0, camp_b1};
  const cudaError_t e = cudaLaunchKernelEx(
      &config, fn, pack, counts, n_equiv, quorum_ok, shared, new_pack,
      partials, T, P, n_w, d, ck0, ck1, rk, m, nf, eps, textbook, byz,
      freeze);
  if (e != cudaSuccess) return (int)e;
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

// Clusters of C blocks of `warps` warps of the fused kernel in the given
// coin and equiv modes that the current device holds at once -> *clusters
// (cudaOccupancyMaxActiveClusters of fused_round_kernel, a cluster of one
// block, at C = 1, else of fused_cluster_kernel).  For C > 8 it first
// allows that cluster kernel non-portable cluster sizes, which the launch
// of such a grid needs: the wrapper's grid rule (ops/packed_round.py
// fused_grid) reads these counts before its first launch in these modes on
// a device.  Returns the cudaError (0 = set).
extern "C" int benor_fused_fits(int C, int warps, int coin, int equiv,
                                int* clusters) {
  const FusedFn fn = fused_fn(C > 1, coin, equiv);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (C > kPortableCluster)
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = fused_config(C, warps, 1, 0, &attr);
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)fn,
                                             &config);
}

// One launch of the fused kernel as T clusters of C blocks of `warps`
// warps (ops/packed_round.py fused_grid's choice): fused_round_kernel at
// C = 1, else fused_cluster_kernel.  A grid it does not take, a mode
// combination that is not built (honest must equal equiv: sampled counts),
// or a refused cluster launch returns its cudaError: nothing falls back.
extern "C" int benor_fused_round(const uint32_t* pack, const float* hist1,
                                 const float* n_equiv, const int* shared,
                                 uint32_t* new_pack, int* parts_a,
                                 int* parts_b, int T, int P, int n_w,
                                 uint32_t pk0, uint32_t pk1, uint32_t pk20,
                                 uint32_t pk21, uint32_t vk0, uint32_t vk1,
                                 uint32_t vk20, uint32_t vk21, uint32_t ck0,
                                 uint32_t ck1, int rk, float m, float nf,
                                 float eps, int coin_mode, int equiv,
                                 int textbook, int byz, int honest,
                                 int freeze, int C, int warps,
                                 cudaStream_t stream) {
  if (!fused_dims_ok(n_w, C, warps) || pop_of(kSampled, equiv, honest) < 0)
    return (int)cudaErrorInvalidValue;
  const FusedFn fn = fused_fn(C > 1, coin_mode, equiv);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(C, warps, T, stream, &attr);
  const Draw pd{pk0, pk1, pk20, pk21, 0u, 0u};
  const Draw vd{vk0, vk1, vk20, vk21, 0u, 0u};
  const cudaError_t e = cudaLaunchKernelEx(
      &config, fn, pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b,
      P, n_w, pd, vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
