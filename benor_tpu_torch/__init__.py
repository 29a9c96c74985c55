"""benor_tpu_torch — the Ben-Or simulator on PyTorch and CUDA.

A port of ``benor_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
``SimConfig``, the same node state and the same random streams, with the
round kernels, the histogram samplers and the dense tally written by hand
in CUDA C++ for ``sm_90a`` (csrc/).  It imports neither JAX nor the JAX package.

    from benor_tpu_torch import SimConfig, simulate, observable_state
    cfg = SimConfig(n_nodes=10, n_faulty=4, max_rounds=20)
    rounds, final, faults = simulate(cfg, [1] * 10, [True] * 4 + [False] * 6)
    observable_state(cfg, final, faults, 5)    # the reference's /getState

    from benor_tpu_torch import launch_network   # launch / start / stop
    net = launch_network(10, 4, [0, 0, 1, 1, 1, 0, 0, 1, 1, 1],
                         [True] * 4 + [False] * 6)
    net.start()
    net.get_states()

    net = launch_network(10, 4, [1] * 10, [True] * 4 + [False] * 6,
                         backend="express")   # or "native": host oracles
    from benor_tpu_torch.backends.http_api import serve_network
    with serve_network(net, base_port=3000):   # /status /start /stop
        ...                                    # /getState on 3000 + i

    from benor_tpu_torch.sweep import run_curve_batched  # sweeps
    cb = run_curve_batched(SimConfig(n_nodes=100_000, n_faulty=0,
                                     trials=32, delivery="quorum"),
                           [10_000, 30_000, 40_000],
                           journal_path="sweep.jsonl")

    from benor_tpu_torch.atlas.manifest import capture_atlas  # the atlas
    doc = capture_atlas(("quorum",))      # cliffs, audits, shrunk repros

    from benor_tpu_torch import results  # the science studies
    results.generate(out_dir="RESULTS")   # RESULTS/results.json, RESULTS.md

    from benor_tpu_torch.serve import ServeApp   # the request plane
    with ServeApp(port=8400) as app:      # POST /v1/jobs (SSE), /v1/stats
        ...

The command line (``python -m benor_tpu_torch``; the JAX package's
arguments, lines and exit codes):

    python -m benor_tpu_torch                       # the start.ts demo
    python -m benor_tpu_torch sweep --n 100000 --f-values 10000,40000
    python -m benor_tpu_torch coins | preset NAME | results
    python -m benor_tpu_torch audit --f 4 --scheduler targeted --balanced
                                                    # exit 2: violations
    python -m benor_tpu_torch atlas --searches quorum
    python -m benor_tpu_torch replay repro.json
    python -m benor_tpu_torch trace --out trace.json --metrics-out m.prom
    python -m benor_tpu_torch demo --backend express   # no device
    python -m benor_tpu_torch serve --port 8400      # the request plane
    python -m benor_tpu_torch load --clients 1000    # its load test
    python -m benor_tpu_torch sweep --n 100000 --f-values 10000,40000 \
        --batched --heartbeat-rounds 1 --heartbeat-out hb.jsonl
    python -m benor_tpu_torch watch hb.jsonl         # no device

All run on CUDA unless ``device="cpu"`` (``--device cpu``) is passed,
but the event-loop oracles and ``watch``, which run on the host.
"""

from .api import launch_network
from .backends import TpuNetwork
from .config import SimConfig, VAL0, VAL1, VALQ
from .sim import (resume_consensus, run_consensus, run_consensus_slice,
                  run_consensus_traced, simulate)
from .state import DynParams, FaultSpec, NetState, init_state, observable_state

__all__ = ["SimConfig", "VAL0", "VAL1", "VALQ", "DynParams", "FaultSpec",
           "NetState", "TpuNetwork", "init_state", "launch_network",
           "observable_state", "resume_consensus", "run_consensus",
           "run_consensus_slice", "run_consensus_traced", "simulate"]
