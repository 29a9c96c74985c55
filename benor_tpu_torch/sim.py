"""Simulation entry points (port of benor_tpu/sim.py:189-192, 245-457).

Two round loops, as in the JAX package: the packed loop
(ops/packed_round.py, the fused round kernels) when
``tally.pallas_round_active`` — the uniform-scheduler CF regime of the
histogram path and the count-controlling adversaries (``scheduler=
'adversarial'`` / ``'targeted'``, their closed-form counts), under every
coin and fault model — and the unfused loop
(models/benor.py) otherwise, in four regimes.  ``delivery='all'``
(the JAX package's default; on either path, omission aside) tallies the
broadcast histogram in plain torch, no kernel, as the JAX package does in
plain XLA: the packed loop never serves it, whatever
``use_pallas_round`` says.  On the histogram path the unfused loop serves
the same CF regime as the packed loop with the samplers and coins of
ops/hist.py; on the dense path (``path='dense'``, or ``'auto'`` at
N <= dense_path_max_n) it serves quorum delivery under the uniform and
biased schedulers and per-edge omission (``delivery='all'`` with
``drop_prob``): explicit [T, N, N] delivery masks (ops/scheduler.py)
tallied exactly (ops/dense.py); under the count-controlling adversaries,
on either path, the closed-form counts of ops/tally.py.  All four take
every fault model — crash, byzantine, equivocate, crash_at_round and
crash_recover (down-intervals with durable or amnesia rejoins,
faults/recovery.py) — private, common or weak-common coins, either
decision rule, freeze on or off.  Every other regime raises
``NotImplementedError`` naming the ROADMAP item that will bring it;
nothing falls back to another path.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import SimConfig, unported
from .models import benor
from .ops import packed_round, tally
from .state import FaultSpec, NetState, init_state


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller names another.  With
    no CUDA device and no explicit ``"cpu"`` this raises — a run never
    moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "benor_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain torch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError unless one of the port's loops serves
    cfg."""
    if cfg.mesh_shape is not None:
        unported("mesh_shape (sharded runs)", "15")
    if cfg.record or cfg.witness or cfg.kernel_telemetry:
        unported("record / witness / kernel_telemetry", "11")
    if cfg.debug:
        unported("debug=True (the per-round host callback)", "5")
    if not tally.pallas_round_active(cfg):
        gap = benor.round_gap(cfg)
        if gap is not None:
            unported(*gap)


def start_state(cfg: SimConfig, state: NetState) -> NetState:
    """The /start transition: live lanes set k=1."""
    k = torch.where(~state.killed, torch.ones_like(state.k), state.k)
    return NetState(x=state.x, decided=state.decided, k=k,
                    killed=state.killed)


def _unfused_slice(cfg, state, faults, seed, from_round, until_round):
    """The unfused round loop -> (next_round, state).  The JAX package runs
    it on the device (lax.while_loop); here it runs on the host and reads
    the settled predicate once per round, with the same condition
    ``(r <= max_rounds) & ~all_settled & (r < until_round)``."""
    r = int(from_round)
    while r <= cfg.max_rounds and r < until_round and \
            not bool(benor.all_settled(state)):
        state = benor.benor_round(cfg, state, faults, seed, r)
        r += 1
    return r, state


def _slice(cfg, state, faults, from_round, until_round):
    """The loop that serves cfg, from ``from_round`` up to (not including)
    ``until_round`` -> (next_round, state)."""
    check_supported(cfg)
    run = (packed_round.run_packed_slice if tally.pallas_round_active(cfg)
           else _unfused_slice)
    return run(cfg, state, faults, cfg.seed, from_round, until_round)


def run_consensus(cfg: SimConfig, state: NetState, faults: FaultSpec):
    """Run from /start to termination or the round cap on the device the
    state lives on -> (rounds_executed, final_state).  cfg.seed keys every
    stream exactly as ``jax.random.key(cfg.seed)`` keys the JAX package's."""
    r, final = _slice(cfg, start_state(cfg, state), faults, 1,
                      cfg.max_rounds + 2)
    return r - 1, final


def run_consensus_slice(cfg: SimConfig, state: NetState, faults: FaultSpec,
                        from_round: int, until_round: int):
    """At most ``until_round - from_round`` rounds of the loop ->
    (next_round, state); ``next_round == from_round`` means no progress was
    possible (already settled or past the round cap).  Randomness keys on
    (seed, round, phase, trial, node), never on how the loop was entered,
    so a run in slices equals the one-shot run bit for bit.  ``state`` is
    taken as given: the first slice of a run starts from
    ``start_state(cfg, state)``."""
    return _slice(cfg, state, faults, from_round, until_round)


def resume_consensus(cfg: SimConfig, state: NetState, faults: FaultSpec,
                     from_round: int):
    """Re-enter the loop from a checkpointed round index -> (rounds_executed,
    final_state), rounds counted from round 1 as ``run_consensus`` counts
    them."""
    r, final = _slice(cfg, state, faults, from_round, cfg.max_rounds + 2)
    return r - 1, final


def simulate(cfg: SimConfig, initial_values, faulty_list=None,
             faults: Optional[FaultSpec] = None, crash_rounds=None,
             device=None):
    """One-shot run: build state, run, return (rounds, state, faults).

    ``faulty_list`` is the reference's launch-time fault vector;
    ``crash_rounds`` is required for fault_model='crash_at_round'; pass
    ``faults`` for per-trial specs (``faults.crash_recover_faults`` builds
    crash_recover's from cfg.recovery).  Runs on CUDA unless ``device``
    names the CPU."""
    dev = resolve_device(device)
    check_supported(cfg)
    if faults is None:
        if faulty_list is None:
            faulty_list = [False] * cfg.n_nodes
        faults = FaultSpec.from_faulty_list(cfg, faulty_list, crash_rounds,
                                            device=dev)
    else:
        faults = faults.to(dev)
    state = init_state(cfg, initial_values, faults)
    rounds, final = run_consensus(cfg, state, faults)
    return rounds, final, faults
