"""benor_tpu_torch — the Ben-Or simulator on PyTorch and CUDA.

A port of ``benor_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
``SimConfig``, the same node state and the same random streams, with the
round kernels, the histogram samplers and the dense tally written by hand
in CUDA C++ for ``sm_90a`` (csrc/).  It imports neither JAX nor the JAX package.

    from benor_tpu_torch import SimConfig, simulate
    cfg = SimConfig(n_nodes=1_000_000, n_faulty=250_000, trials=32,
                    delivery="quorum", scheduler="uniform",
                    path="histogram", use_pallas_hist=True,
                    use_pallas_round=True, max_rounds=64)
    rounds, state, faults = simulate(cfg, initial_values)   # on CUDA
"""

from .config import SimConfig, VAL0, VAL1, VALQ
from .sim import (resume_consensus, run_consensus, run_consensus_slice,
                  simulate)
from .state import FaultSpec, NetState, init_state

__all__ = ["SimConfig", "VAL0", "VAL1", "VALQ", "FaultSpec", "NetState",
           "init_state", "resume_consensus", "run_consensus",
           "run_consensus_slice", "simulate"]
