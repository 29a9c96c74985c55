// The armed twins of the three round kernels (csrc/round_body.cuh,
// proposal_hist_obs_kernel, vote_commit_obs_kernel, fused_round_obs_kernel
// and fused_cluster_obs_kernel) under the static fault models, in every
// counts, coin and Pop mode the unarmed kernels are built in: the flight
// recorder's columns, the witness and the stage counters of
// benor_tpu/ops/pallas_round.py (_vote_partial_cols, _witness_cols,
// _telem_cols).  csrc/round_obs_b2.cu builds the round-bound models'; the
// C interface of csrc/round_kernels.cu launches them through
// obs_round_kernel.  They build in translation units of their own so that
// nvcc compiles them beside the unarmed kernels, whose code they leave as
// it was.
//
// Build: as round_kernels.cu (ops/_build.py).

#include "round_body.cuh"

// The round-bound models' armed twins (csrc/round_obs_b2.cu).
const void* obs_b2_kernel(int kernel, int counts, int coin, int pop,
                          int fault);

// Kernel 0 proposal_hist, 1 vote_commit, 2 fused_round, 3 fused_cluster's
// armed twin in the counts, coin, Pop and fault modes -> its address, or
// nullptr for a combination that is not built.
const void* obs_round_kernel(int kernel, int counts, int coin, int pop,
                             int fault) {
  if (fault == kStatic)
    return obs_kernel<kStatic>(kernel, counts, coin, pop);
  return obs_b2_kernel(kernel, counts, coin, pop, fault);
}
