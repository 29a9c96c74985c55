// The round kernels' instantiations under the round-bound fault models,
// crash_at_round (kCrashAt) and crash_recover (kRecover): the body of
// csrc/round_body.cuh in every counts and coin mode the JAX package's
// dispatch reaches with those models (Pop all live; the fused kernel in its
// two forms, sampled counts), 36 kernels.  round_kernels.cu describes them
// and launches them through b2_round_kernel; they build in a translation
// unit of their own so that nvcc compiles them beside the static models'.
//
// Build: as round_kernels.cu (ops/_build.py).

#include "round_body.cuh"

namespace {

template <int kFault, int kCounts>
const void* b2_vote(int coin) {
  switch (coin) {
    case kPrivate:
      return (const void*)vote_commit_kernel<kCounts, kPrivate, kAllLive,
                                             kFault>;
    case kCommon:
      return (const void*)vote_commit_kernel<kCounts, kCommon, kAllLive,
                                             kFault>;
    case kWeak:
      return (const void*)vote_commit_kernel<kCounts, kWeak, kAllLive,
                                             kFault>;
  }
  return nullptr;
}

template <int kFault, int kCoin>
const void* b2_fused(bool cluster) {
  return cluster ? (const void*)fused_cluster_kernel<kCoin, false, kFault>
                 : (const void*)fused_round_kernel<kCoin, false, kFault>;
}

template <int kFault>
const void* b2_kernel(int kernel, int counts, int coin) {
  if (kernel == 0) {
    switch (counts) {
      case kSampled:
        return (const void*)proposal_hist_kernel<kSampled, kAllLive, kFault>;
      case kDelivered:
        return (const void*)
            proposal_hist_kernel<kDelivered, kAllLive, kFault>;
      case kCamps:
        return (const void*)proposal_hist_kernel<kCamps, kAllLive, kFault>;
    }
    return nullptr;
  }
  if (kernel == 1) {
    switch (counts) {
      case kSampled: return b2_vote<kFault, kSampled>(coin);
      case kDelivered: return b2_vote<kFault, kDelivered>(coin);
      case kCamps: return b2_vote<kFault, kCamps>(coin);
    }
    return nullptr;
  }
  if ((kernel == 2 || kernel == 3) && counts == kSampled) {
    switch (coin) {
      case kPrivate: return b2_fused<kFault, kPrivate>(kernel == 3);
      case kCommon: return b2_fused<kFault, kCommon>(kernel == 3);
      case kWeak: return b2_fused<kFault, kWeak>(kernel == 3);
    }
  }
  return nullptr;
}

}  // namespace

// Kernel 0 proposal_hist, 1 vote_commit, 2 fused_round, 3 fused_cluster in
// the given counts, coin and fault (1 kCrashAt, 2 kRecover) modes -> the
// kernel's address, nullptr for a combination that is not built.
const void* b2_round_kernel(int kernel, int counts, int coin, int fault) {
  if (fault == kCrashAt) return b2_kernel<kCrashAt>(kernel, counts, coin);
  if (fault == kRecover) return b2_kernel<kRecover>(kernel, counts, coin);
  return nullptr;
}
