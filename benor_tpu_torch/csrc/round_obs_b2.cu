// The armed twins of the round kernels under the round-bound fault models,
// crash_at_round (kCrashAt) and crash_recover (kRecover): the armed form of
// csrc/round_b2.cu's 36 kernels.  csrc/round_obs.cu describes them.
//
// Build: as round_kernels.cu (ops/_build.py).

#include "round_body.cuh"

// Kernel 0 proposal_hist, 1 vote_commit, 2 fused_round, 3 fused_cluster's
// armed twin in the counts, coin and Pop modes under fault 1 (kCrashAt) or
// 2 (kRecover) -> its address, nullptr for a combination that is not built.
const void* obs_b2_kernel(int kernel, int counts, int coin, int pop,
                          int fault) {
  if (fault == kCrashAt)
    return obs_kernel<kCrashAt>(kernel, counts, coin, pop);
  if (fault == kRecover)
    return obs_kernel<kRecover>(kernel, counts, coin, pop);
  return nullptr;
}
