// The body of the three round kernels (csrc/round_kernels.cu describes
// them, their modes and their design): the per-lane and per-warp pieces and
// the kernel templates.  Each source that includes it instantiates its own
// modes: round_kernels.cu the static fault models' (the main path's among
// them), round_b2.cu crash_at_round's and crash_recover's.

#pragma once

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
// kernel's one block of 16 warps (128).  The fused kernel's kRecover
// cluster instantiations spilled 20-24 bytes at 64 as well (the private
// and weak coins), so the fused kernel under kRecover takes that bound
// too.
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
// FaultRounds: liveness from the killed plane alone (kStatic), or also
// from each lane's round bounds (kCrashAt: crash_at_round; kRecover:
// crash_recover).
constexpr int kStatic = 0, kCrashAt = 1, kRecover = 2;
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
  uint32_t down_w;                // its lanes down this round (kRecover)
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

// A lane's crash and recover rounds (0: none), the int32 [T, Np]
// operands' entries for its node.
struct Bounds {
  int cr, rcv;
};

// The bounds of lane `lane` of word `word` from its trial's rows `cr` and
// `rcv` (read under the models that have them; 0 for a word past the end).
// A warp's read of a row is one coalesced 128-byte load.
template <int kFault>
__device__ __forceinline__ Bounds load_bounds(const int* cr, const int* rcv,
                                              int word, int lane,
                                              bool in_range) {
  Bounds b{0, 0};
  if constexpr (kFault != kStatic) {
    if (in_range) b.cr = cr[word * kWarp + lane];
  }
  if constexpr (kFault == kRecover) {
    if (in_range) b.rcv = rcv[word * kWarp + lane];
  }
  return b;
}

// The crash-at-round / crash-recover update of round r on a word's planes
// (pallas_round.py _load_fields) -> this lane's new plane word.  A faulty
// lane with 0 < cr <= r has started its interval: under kCrashAt it is
// killed; under kRecover it is killed if it never rejoins (rcv <= 0) and
// down while r < rcv.  The killed plane takes the latched word and, under
// kRecover, the down plane this round's down word, so every later read of
// the word (both phases of the fused kernel, the store) sees the update;
// under `amnesia` an undecided lane at its first round back (r == rcv)
// has its x reset to "?" in the x planes.  kStatic changes nothing.
template <int kFault>
__device__ __forceinline__ uint32_t apply_bounds(uint32_t plane, int lane,
                                                 const Bounds& b, int r,
                                                 int amnesia) {
  if constexpr (kFault == kStatic) {
    return plane;
  } else {
    const bool faulty =
        lane_bit(__shfl_sync(kFull, plane, kPlaneFaulty), lane);
    const bool started = faulty && b.cr > 0 && r >= b.cr;
    if constexpr (kFault == kCrashAt) {
      const uint32_t crashing = __ballot_sync(kFull, started);
      return lane == kPlaneKilled ? (plane | crashing) : plane;
    } else {
      const uint32_t never = __ballot_sync(kFull, started && b.rcv <= 0);
      const uint32_t down =
          __ballot_sync(kFull, started && b.rcv > 0 && r < b.rcv);
      uint32_t rejoin = 0u;
      if (amnesia) {  // warp-uniform
        const bool decided =
            lane_bit(__shfl_sync(kFull, plane, kPlaneDecided), lane);
        rejoin = __ballot_sync(kFull, faulty && b.cr > 0 && b.rcv > 0 &&
                                          r == b.rcv && !decided);
      }
      return lane == kPlaneX ? (plane & ~rejoin)
             : lane == kPlaneX + 1 ? (plane | rejoin)
             : lane == kPlaneKilled ? (plane | never)
             : lane == kPlaneDown ? down : plane;
    }
  }
}

// The lane's fields from the word's planes (after apply_bounds): a lane is
// alive when neither killed nor, under kRecover, down.
template <int kFault>
__device__ __forceinline__ Lane lane_from(uint32_t plane, int lane,
                                          int freeze) {
  Lane f;
  f.plane = plane;
  const uint32_t x0 = __shfl_sync(kFull, f.plane, kPlaneX);
  const uint32_t x1 = __shfl_sync(kFull, f.plane, kPlaneX + 1);
  f.dec_w = __shfl_sync(kFull, f.plane, kPlaneDecided);
  f.kil_w = __shfl_sync(kFull, f.plane, kPlaneKilled);
  f.fau_w = __shfl_sync(kFull, f.plane, kPlaneFaulty);
  f.down_w = kFault == kRecover ? __shfl_sync(kFull, f.plane, kPlaneDown)
                                : 0u;
  f.x = (int)lane_bit(x0, lane) | ((int)lane_bit(x1, lane) << 1);
  f.decided = lane_bit(f.dec_w, lane);
  f.alive = !lane_bit(f.kil_w | f.down_w, lane);
  f.faulty = lane_bit(f.fau_w, lane);
  f.frozen = freeze && f.decided;
  return f;
}

// Byzantine lanes broadcast bit-flipped values (0 <-> 1, "?" kept).
__device__ __forceinline__ int sent(int byz, int v, bool faulty) {
  if (byz && faulty) return v == kVal0 ? kVal1 : (v == kVal1 ? kVal0 : v);
  return v;
}

// The word's lanes the vote histograms count: the live lanes (neither
// killed nor down), less the equivocators where kHonest (pallas_round.py
// _honest).
template <bool kHonest>
__device__ __forceinline__ uint32_t honest_word(const Lane& f) {
  if constexpr (kHonest) return ~(f.kil_w | f.down_w) & ~f.fau_w;
  return ~(f.kil_w | f.down_w);
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
// faulty keep their words (killed the latched one of apply_bounds), down
// is this round's down word under kRecover and else 0, and k takes rk in
// the active lanes: plane k_b of the word is (old | active) where bit b of
// rk is set, else (old & ~active).  Returns the new decided word.
template <int kFault>
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
                     : lane == kPlaneDown ? (kFault == kRecover ? f.plane
                                                                : 0u)
                     : lane >= kPlaneK ? k_new : f.plane;
  if (lane < P) words[lane * stride] = w;
  return dec;
}

// Proposal-pass counts of one lane's warp: the sent-vote histogram over
// the histograms' lanes and the alive count (equivocators included, down
// lanes not).
template <bool kHonest>
__device__ __forceinline__ void proposal_counts(int* acc, const Lane& f,
                                                int vote) {
  const uint32_t hon = honest_word<kHonest>(f);
  const int n0 = __popc(__ballot_sync(kFull, vote == kVal0) & hon);
  const int n1 = __popc(__ballot_sync(kFull, vote == kVal1) & hon);
  const int alive = __popc(~(f.kil_w | f.down_w));
  acc[0] += n0;
  acc[1] += n1;
  acc[2] += (kHonest ? __popc(hon) : alive) - n0 - n1;
  acc[3] += alive;
}

// Vote-pass counts of one lane's warp: next round's proposal histogram over
// the histograms' lanes, settled (decided or latched killed: a down lane is
// unsettled) and unsettled.
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
// equivocators a trial (kEquivDraws only); ``cr`` / ``rcv``: the lanes'
// crash and recover rounds, int32 [T, n_w x 32] (read under kCrashAt /
// kRecover), ``r`` the round they are held against and ``amnesia`` the
// rejoin mode (kRecover).
template <int kCounts, int kPop, int kFault>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  kPop == kEquivDraws ? kMinBlocksEquiv
                                                      : kMinBlocksPerSM)
proposal_hist_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ counts,
                     const float* __restrict__ n_equiv,
                     int* __restrict__ partials, int T, int P, int n_w,
                     Draw d, float m, int byz, int freeze,
                     const int* __restrict__ cr, const int* __restrict__ rcv,
                     int r, int amnesia) {
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
  const size_t trow = (size_t)trial * n_w * kWarp;
  int acc[kPropCols] = {0, 0, 0, 0};
  // a word's planes (and bounds) are loaded one word ahead, so the load
  // overlaps the draws of the word before
  const int step = gridDim.x * kWarpsPerBlock;
  int word = blockIdx.x * kWarpsPerBlock + warp;
  uint32_t plane = load_plane(tpack + word, P, stride, lane, word < n_w);
  Bounds bnd = load_bounds<kFault>(cr + trow, rcv + trow, word, lane,
                                   word < n_w);
  for (; word < n_w; word += step) {  // warp-uniform
    const uint32_t next = load_plane(tpack + word + step, P, stride, lane,
                                     word + step < n_w);
    const Bounds next_bnd = load_bounds<kFault>(
        cr + trow, rcv + trow, word + step, lane, word + step < n_w);
    const Lane f = lane_from<kFault>(
        apply_bounds<kFault>(plane, lane, bnd, r, amnesia), lane, freeze);
    const int vote = proposal_vote(f, d, (uint32_t)(word * kWarp + lane),
                                   (uint32_t)trial, tt, byz);
    proposal_counts<kPop != kAllLive>(acc, f, vote);
    plane = next;
    bnd = next_bnd;
  }
  if (lane == 0)
    for (int c = 0; c < kPropCols; ++c) smem[warp][c] = acc[c];
  block_sum<kPropCols>(smem, kWarpsPerBlock,
                       partials + ((size_t)blockIdx.x * T + trial) * kPropCols);
}

// grid (blocks, T), 8 warps a block, words walked as in proposal_hist.
// ``shared``: the trial's shared coin bit (common and weak coins only);
// the bounds are held against round rk - 1.
template <int kCounts, int kCoin, int kPop, int kFault>
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
                   float eps, int textbook, int byz, int freeze,
                   const int* __restrict__ cr, const int* __restrict__ rcv,
                   int amnesia) {
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
  const size_t trow = (size_t)trial * n_w * kWarp;
  int acc[kVoteCols] = {0, 0, 0, 0, 0};
  const int step = gridDim.x * kWarpsPerBlock;   // loads one word ahead
  int word = blockIdx.x * kWarpsPerBlock + warp;
  uint32_t plane = load_plane(pack + tbase + word, P, stride, lane,
                              word < n_w);
  Bounds bnd = load_bounds<kFault>(cr + trow, rcv + trow, word, lane,
                                   word < n_w);
  for (; word < n_w; word += step) {  // warp-uniform
    const uint32_t next = load_plane(pack + tbase + word + step, P, stride,
                                     lane, word + step < n_w);
    const Bounds next_bnd = load_bounds<kFault>(
        cr + trow, rcv + trow, word + step, lane, word + step < n_w);
    const Lane f = lane_from<kFault>(
        apply_bounds<kFault>(plane, lane, bnd, rk - 1, amnesia), lane,
        freeze);
    plane = next;
    bnd = next_bnd;
    const Commit c = vote_lane<kCounts, kCoin, kEquiv>(
        f, d, ck0, ck1, (uint32_t)(word * kWarp + lane), (uint32_t)trial,
        tt, nf, qok, textbook, shared_bit, eps);
    const uint32_t dec = store_planes<kFault>(new_pack + tbase + word, P,
                                              stride, lane, f, c, rk);
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
// live lanes exactly where kEquiv.  Under kCrashAt / kRecover each kept
// word has the bounds of round rk - 1 (both phases' round) applied once, as
// it is loaded, so both phases and the store read the update.
template <bool kCluster, int kCoin, bool kEquiv, int kFault>
__device__ __forceinline__ void fused_round_body(
    const uint32_t* __restrict__ pack, const float* __restrict__ hist1,
    const float* __restrict__ n_equiv, const int* __restrict__ shared,
    uint32_t* __restrict__ new_pack, int* __restrict__ parts_a,
    int* __restrict__ parts_b, int P, int n_w, const Draw& pd,
    const Draw& vd, uint32_t ck0, uint32_t ck1, int rk, float m, float nf,
    float eps, int textbook, int byz, int freeze, const int* __restrict__ cr,
    const int* __restrict__ rcv, int amnesia) {
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
  if constexpr (kFault != kStatic) {
    const size_t trow = (size_t)trial * n_w * kWarp;
#pragma unroll
    for (int k = 0; k < kFusedKeep; ++k) {
      const int word = first + k * step;
      kept[k] = apply_bounds<kFault>(
          kept[k], lane,
          load_bounds<kFault>(cr + trow, rcv + trow, word, lane, word < n_w),
          rk - 1, amnesia);
    }
  }

  // --- phase 1: proposal tallies -> majority -> vote values -------------
  const TrialTerms<kSampled, kEquiv> tt1 =
      block_terms(&tt_s, hist1, n_equiv, trial, m);
  int acc_a[kPropCols] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < kFusedKeep; ++k) {
    const int word = first + k * step;
    if (word < n_w) {  // warp-uniform
      const Lane f = lane_from<kFault>(kept[0], lane, freeze);
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
      const Lane f = lane_from<kFault>(kept[0], lane, freeze);
      const Commit c = vote_lane<kSampled, kCoin, kEquiv>(
          f, vd, ck0, ck1, (uint32_t)(word * kWarp + lane), (uint32_t)trial,
          tt2, nf, qok, textbook, shared_bit, eps);
      const uint32_t dec = store_planes<kFault>(new_pack + tbase + word, P,
                                                stride, lane, f, c, rk);
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
template <int kCoin, bool kEquiv, int kFault>
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp,
                                  kEquiv || kFault == kRecover
                                      ? kFusedMinBlocksEquiv
                                      : kFusedMinBlocks)
fused_round_kernel(const uint32_t* __restrict__ pack,
                   const float* __restrict__ hist1,
                   const float* __restrict__ n_equiv,
                   const int* __restrict__ shared,
                   uint32_t* __restrict__ new_pack,
                   int* __restrict__ parts_a, int* __restrict__ parts_b,
                   int P, int n_w, Draw pd, Draw vd, uint32_t ck0,
                   uint32_t ck1, int rk, float m, float nf, float eps,
                   int textbook, int byz, int freeze, const int* cr,
                   const int* rcv, int amnesia) {
  fused_round_body<false, kCoin, kEquiv, kFault>(
      pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b, P, n_w, pd,
      vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze, cr, rcv, amnesia);
}

// grid (C x T) blocks of W warps, launched as T clusters of C blocks.
template <int kCoin, bool kEquiv, int kFault>
__global__ void __launch_bounds__(kFusedMaxWarps * kWarp,
                                  kEquiv || kFault == kRecover
                                      ? kFusedMinBlocksEquiv
                                      : kFusedMinBlocks)
fused_cluster_kernel(const uint32_t* __restrict__ pack,
                     const float* __restrict__ hist1,
                     const float* __restrict__ n_equiv,
                     const int* __restrict__ shared,
                     uint32_t* __restrict__ new_pack,
                     int* __restrict__ parts_a, int* __restrict__ parts_b,
                     int P, int n_w, Draw pd, Draw vd, uint32_t ck0,
                     uint32_t ck1, int rk, float m, float nf, float eps,
                     int textbook, int byz, int freeze, const int* cr,
                     const int* rcv, int amnesia) {
  fused_round_body<true, kCoin, kEquiv, kFault>(
      pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b, P, n_w, pd,
      vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze, cr, rcv, amnesia);
}

}  // namespace
