// The three round kernels of the packed Ben-Or main path, for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of benor_tpu/ops/pallas_round.py:
//   proposal_hist_kernel <- _prop_hist_kernel    (proposal_hist_pallas)
//   vote_commit_kernel   <- _vote_commit_kernel  (vote_commit_pallas)
//   fused_round_kernel   <- _fused_round_kernel  (fused_round_pallas),
//   fused_cluster_kernel    its cluster form (the same body)
// in every counts regime, coin and fault model the JAX package's packed
// round serves (crash_at_round and crash_recover included), either
// decision rule, freeze on or off.  Their plain torch versions live beside
// the wrappers in ops/packed_round.py.  The kernels' body is
// csrc/round_body.cuh; this source builds the static fault models'
// instantiations and the C interface, csrc/round_b2.cu the round-bound
// models' (two translation units, compiled side by side).
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
//  - FaultRounds: kStatic, liveness from the killed plane alone (crash,
//    byzantine, equivocate); kCrashAt (crash_at_round) and kRecover
//    (crash_recover), where each lane's crash and recover rounds, int32
//    [T, Np] operands read a word ahead like the planes, are held against
//    the round first (pallas_round.py _load_fields): the killed plane
//    latches the crashed lanes, under kRecover the down plane holds this
//    round's down lanes (alive = not killed and not down; settled = decided
//    or killed, so a down lane is unsettled) and, under the runtime flag
//    ``amnesia``, an undecided lane at its first round back restarts from
//    "?".  Under these two models Pop is all live;
//  - ``byz`` stays a runtime flag: it flips the byzantine lanes' sent
//    values.
// The fused kernel serves sampled counts only (kSampled x CoinMode x
// kEquiv); delivered and camps rounds always take the pair.  The
// instantiations <kSampled, kPrivate, kAllLive, kStatic> and <kPrivate,
// false, kStatic> are the main path's, as they were before the modes came
// in.
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

#include "round_body.cuh"

// The round-bound models' instantiations (csrc/round_b2.cu): kernel 0
// proposal_hist, 1 vote_commit, 2 fused_round, 3 fused_cluster, in the
// counts, coin and fault (kCrashAt or kRecover) modes -> its address, or
// nullptr for a combination that is not built.
const void* b2_round_kernel(int kernel, int counts, int coin, int fault);

namespace {

// The instantiations the JAX package's dispatch can reach, by mode (nullptr
// for any other combination): the static fault models' here, the
// round-bound models' from round_b2.cu.
using ProposalFn = void (*)(const uint32_t*, const float*, const float*,
                            int*, int, int, int, Draw, float, int, int,
                            const int*, const int*, int, int);
using VoteFn = void (*)(const uint32_t*, const float*, const float*,
                        const int*, const int*, uint32_t*, int*, int, int,
                        int, Draw, uint32_t, uint32_t, int, float, float,
                        float, int, int, int, const int*, const int*, int);
using FusedFn = void (*)(const uint32_t*, const float*, const float*,
                         const int*, uint32_t*, int*, int*, int, int, Draw,
                         Draw, uint32_t, uint32_t, int, float, float, float,
                         int, int, int, const int*, const int*, int);

// A round-bound instantiation of round_b2.cu (b2_round_kernel) as this
// source's function type: both sources build the same body, so the
// parameter lists agree.
template <typename Fn>
Fn b2_fn(int kernel, int counts, int coin, int fault) {
  return reinterpret_cast<Fn>(
      const_cast<void*>(b2_round_kernel(kernel, counts, coin, fault)));
}

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
    case kAllLive: return proposal_hist_kernel<kCounts, kAllLive, kStatic>;
    case kHonestLive:
      if constexpr (kCounts == kSampled) return nullptr;
      else return proposal_hist_kernel<kCounts, kHonestLive, kStatic>;
    case kEquivDraws:
      if constexpr (kCounts != kSampled) return nullptr;
      else return proposal_hist_kernel<kCounts, kEquivDraws, kStatic>;
  }
  return nullptr;
}

ProposalFn proposal_fn(int counts, int equiv, int honest, int fault) {
  const int pop = pop_of(counts, equiv, honest);
  if (fault != kStatic)
    return pop == kAllLive ? b2_fn<ProposalFn>(0, counts, kPrivate, fault)
                           : nullptr;
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
    case kPrivate: return vote_commit_kernel<kCounts, kPrivate, kPop, kStatic>;
    case kCommon: return vote_commit_kernel<kCounts, kCommon, kPop, kStatic>;
    case kWeak: return vote_commit_kernel<kCounts, kWeak, kPop, kStatic>;
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

VoteFn vote_fn(int counts, int coin, int equiv, int honest, int fault) {
  const int pop = pop_of(counts, equiv, honest);
  if (fault != kStatic)
    return pop == kAllLive ? b2_fn<VoteFn>(1, counts, coin, fault) : nullptr;
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
      return cluster ? fused_cluster_kernel<kPrivate, kEquiv, kStatic>
                     : fused_round_kernel<kPrivate, kEquiv, kStatic>;
    case kCommon:
      return cluster ? fused_cluster_kernel<kCommon, kEquiv, kStatic>
                     : fused_round_kernel<kCommon, kEquiv, kStatic>;
    case kWeak:
      return cluster ? fused_cluster_kernel<kWeak, kEquiv, kStatic>
                     : fused_round_kernel<kWeak, kEquiv, kStatic>;
  }
  return nullptr;
}

FusedFn fused_fn(bool cluster, int coin, int equiv, int fault) {
  if (fault != kStatic)
    return equiv ? nullptr
                 : b2_fn<FusedFn>(cluster ? 3 : 2, kSampled, coin, fault);
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
// 'equivocate': with sampled counts exactly where equiv); fault 0 static,
// 1 crash_at_round, 2 crash_recover (equiv and honest 0), whose launches
// read the int32 [T, n_w x 32] rounds ``cr`` (and ``rcv`` under 2) and,
// under 2, ``amnesia`` (1: the amnesia rejoin).

// Blocks a trial of proposal_hist (kernel 0) or vote_commit (kernel 1) in
// the given modes on the current device for n_w plane words and T trials
// -> *blocks: as many as fit T times in one wave of the kernel over the
// card (the SMs times the blocks an SM holds), at least one, and never more
// than a warp a word.  Rounding up would put the last few blocks in a
// second wave of their own.  The caller works it out once per shape and
// modes, sizes the [blocks, T, cols] partials from it and passes it to the
// launcher.  Returns the first failed query's cudaError (0 = *blocks set).
extern "C" int benor_round_blocks(int kernel, int counts, int coin,
                                  int equiv, int honest, int fault, int n_w,
                                  int T, int* blocks) {
  const void* fn =
      kernel == 0 ? (const void*)proposal_fn(counts, equiv, honest, fault)
                  : (const void*)vote_fn(counts, coin, equiv, honest, fault);
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
                                   const int* cr, const int* rcv, int r,
                                   int fault, int amnesia, int blocks,
                                   cudaStream_t stream) {
  const ProposalFn fn = proposal_fn(counts_mode, equiv, honest, fault);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t config = pair_config(blocks, T, stream);
  const Draw d{k0, k1, k20, k21, camp_b0, camp_b1};
  const cudaError_t e = cudaLaunchKernelEx(&config, fn, pack, counts,
                                           n_equiv, partials, T, P, n_w, d,
                                           m, byz, freeze, cr, rcv, r,
                                           amnesia);
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
                                 int freeze, const int* cr, const int* rcv,
                                 int fault, int amnesia, int blocks,
                                 cudaStream_t stream) {
  const VoteFn fn = vote_fn(counts_mode, coin_mode, equiv, honest, fault);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t config = pair_config(blocks, T, stream);
  const Draw d{vk0, vk1, vk20, vk21, camp_b0, camp_b1};
  const cudaError_t e = cudaLaunchKernelEx(
      &config, fn, pack, counts, n_equiv, quorum_ok, shared, new_pack,
      partials, T, P, n_w, d, ck0, ck1, rk, m, nf, eps, textbook, byz,
      freeze, cr, rcv, amnesia);
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
// coin, equiv and fault modes that the current device holds at once -> *clusters
// (cudaOccupancyMaxActiveClusters of fused_round_kernel, a cluster of one
// block, at C = 1, else of fused_cluster_kernel).  For C > 8 it first
// allows that cluster kernel non-portable cluster sizes, which the launch
// of such a grid needs: the wrapper's grid rule (ops/packed_round.py
// fused_grid) reads these counts before its first launch in these modes on
// a device.  Returns the cudaError (0 = set).
extern "C" int benor_fused_fits(int C, int warps, int coin, int equiv,
                                int fault, int* clusters) {
  const FusedFn fn = fused_fn(C > 1, coin, equiv, fault);
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
                                 int freeze, const int* cr, const int* rcv,
                                 int fault, int amnesia, int C, int warps,
                                 cudaStream_t stream) {
  if (!fused_dims_ok(n_w, C, warps) || pop_of(kSampled, equiv, honest) < 0)
    return (int)cudaErrorInvalidValue;
  const FusedFn fn = fused_fn(C > 1, coin_mode, equiv, fault);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(C, warps, T, stream, &attr);
  const Draw pd{pk0, pk1, pk20, pk21, 0u, 0u};
  const Draw vd{vk0, vk1, vk20, vk21, 0u, 0u};
  const cudaError_t e = cudaLaunchKernelEx(
      &config, fn, pack, hist1, n_equiv, shared, new_pack, parts_a, parts_b,
      P, n_w, pd, vd, ck0, ck1, rk, m, nf, eps, textbook, byz, freeze, cr,
      rcv, amnesia);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
