"""Simulation entry points (port of benor_tpu/sim.py:28-192, 245-457).

Two round loops, as in the JAX package: the packed loop
(ops/packed_round.py, the fused round kernels) when
``tally.pallas_round_active`` — the uniform-scheduler CF regime of the
histogram path and the count-controlling adversaries (``scheduler=
'adversarial'`` / ``'targeted'``, their closed-form counts), under every
coin and fault model — and the unfused loop (models/benor.py) otherwise,
which serves every regime of the JAX package's round:

- ``delivery='all'`` (the JAX package's default; on either path) tallies
  the broadcast histogram in plain torch, no kernel, as the JAX package
  does in plain XLA — under a partition epoch each group's histogram,
  with ``drop_prob`` the binomially thinned counts (on the dense path an
  explicit per-edge omission mask); the packed loop never serves it,
  whatever ``use_pallas_round`` says;
- on the histogram path under quorum delivery, the CF regime's samplers
  and coins of ops/hist.py (the kernels) where ``use_pallas_hist`` asks
  for them under the uniform scheduler, else the plain samplers of
  ops/sampling.py: the exact shared CDF tables for quorums within
  ``EXACT_TABLE_MAX``, the CF draws above, the biased scheduler's
  strict-priority and fractional forms, equivocation's mixed-population
  draw;
- on the dense path (``path='dense'``, or ``'auto'`` at N <=
  dense_path_max_n), quorum delivery under the uniform and biased
  schedulers: explicit [T, N, N] delivery masks (ops/scheduler.py) tallied
  exactly (ops/dense.py);
- under the count-controlling adversaries, on either path, the
  closed-form counts of ops/tally.py;
- the structured delivery planes (``delivery='all'``): an adjacency
  topology's d + 1 neighbourhood gathers (topo/deliver.py) and per-round
  sampled committees (topo/committees.py).

All take every fault model — crash, byzantine, equivocate, crash_at_round
and crash_recover (down-intervals with durable or amnesia rejoins,
faults/recovery.py) — private, common or weak-common coins, either
decision rule, freeze on or off.  ``debug=True`` emits one event a round
to the sinks of utils/tracing.py after every round of either loop; on a
packed-eligible config the round kernels still run, and the packed loop
unpacks its plane stack after every round to read the event, as the JAX
package's debug loop calls the same kernels between a pack and an unpack
every round; that is announced once per process, as the JAX package
announces its own demotions (``warn_*``).  ``mesh_shape`` raises
``NotImplementedError`` naming ROADMAP Queue A item 15; nothing falls back
to another path.  ``run_consensus_traced`` runs the unfused loop with a
``state.DynParams`` in place of the config's F, quorum, committee knobs
and omission probability: the batched sweep's dynamic buckets
(sweep.py).  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from .config import SimConfig, unported
from .models import benor
from .ops import packed_round, tally
from .state import (DynParams, FaultSpec, NetState, init_state,
                    new_recorder, new_witness)
from .utils.tracing import emit_round_event

#: The device path's roots: the per-round work that the two host loops
#: (ops.packed_round.run_packed_slice and _unfused_slice below) launch,
#: round after round, named module-relative.  benorlint reads this roster
#: by parsing (analysis/visitors.py) and holds every function these reach
#: to the tracer rules: no host sync, no global-generator draw, no Python
#: branch on a tensor, no 64-bit float.  The loops themselves read the
#: unsettled count once a round by design (ROADMAP "Known differences").
#: The two dense tallies are named too: tally._dense_receiver_counts picks
#: one into a variable, a call the analysis does not follow.
DEVICE_ROOTS = (
    "ops.packed_round.packed_round",
    "ops.packed_round.sent_hist_from_pack",
    "ops.packed_round.unsettled_from_pack",
    "ops.packed_round.n_equiv_from_pack",
    "ops.packed_round.pack_state",
    "ops.packed_round.unpack_state",
    "state.recorder_write",
    "state.witness_write",
    "models.benor.benor_round",
    "models.benor.all_settled",
    "ops.tally.dense_counts",
    "ops.dense.dense_counts",
)

#: One warning per process for each demotion the announcers below name.
_debug_demotion_warned = False
_structured_demotion_warned = False
_faults_demotion_warned = False


def delivery_plane(cfg: SimConfig) -> str:
    """Which delivery plane serves this config: 'topology' (adjacency
    neighbour fan-in, topo/deliver.py), 'committee' (per-round sampled
    committees, topo/committees.py) or 'complete' (all-to-all).  The
    round kernels only ever serve 'complete'."""
    if cfg.topology is not None:
        return "topology"
    if cfg.committee_cap:
        return "committee"
    return "complete"


def injection_plane(cfg: SimConfig) -> tuple:
    """Which dynamic fault families this config arms, in fixed order:
    'crash_recover' (per-node down-intervals), 'omission' (per-edge iid
    drops, cfg.drop_prob) and 'partition' (epoch group masks,
    cfg.partition).  crash_recover runs on the round kernels; omission
    and partitions live on the delivery='all' plane, which they never
    serve."""
    fams = []
    if cfg.fault_model == "crash_recover" or cfg.recovery is not None:
        fams.append("crash_recover")
    if cfg.drop_prob:
        fams.append("omission")
    if cfg.partition is not None:
        fams.append("partition")
    return tuple(fams)


def warn_faults_demote_pallas(cfg: SimConfig) -> None:
    """Omission and partitions require delivery='all', which every
    fused-kernel gate rejects, so a use_pallas_round / use_pallas_hist
    config with either armed runs the unfused loop: announced once per
    process, with the JAX package's text.  Every call ticks the
    ``sim.demotion.faults`` counter of the metrics registry: one tick is
    one demoting call (the JAX package ticks once per traced build)."""
    from .utils.metrics import REGISTRY
    REGISTRY.counter("sim.demotion.faults").inc()
    global _faults_demotion_warned
    if _faults_demotion_warned:
        return
    _faults_demotion_warned = True
    warnings.warn(
        "SimConfig(use_pallas_round/use_pallas_hist) has no effect with "
        f"the {'/'.join(injection_plane(cfg))} fault plane armed: the "
        "fused kernels implement lossless complete-graph delivery only, "
        "so this run takes the per-round XLA loop.  Results are exactly "
        "the armed plane's semantics; only the kernel-speed expectation "
        "is off.  (crash_recover alone does NOT demote — the kernels "
        "re-derive down-intervals in-register.)",
        stacklevel=3)


def warn_structured_demotes_pallas(cfg: SimConfig) -> None:
    """A structured delivery plane (cfg.topology / cfg.committee_cap)
    requires delivery='all', which every fused-kernel gate rejects, so a
    use_pallas_round / use_pallas_hist config runs the unfused loop:
    announced once per process, with the JAX package's text.  Every call
    ticks ``sim.demotion.structured`` (one tick a demoting call)."""
    from .utils.metrics import REGISTRY
    REGISTRY.counter("sim.demotion.structured").inc()
    global _structured_demotion_warned
    if _structured_demotion_warned:
        return
    _structured_demotion_warned = True
    warnings.warn(
        "SimConfig(use_pallas_round/use_pallas_hist) has no effect under "
        f"the {delivery_plane(cfg)!r} delivery plane: the fused kernels "
        "implement the complete graph only, so this run takes the "
        "per-round XLA loop (the topo gather/scatter tallies).  Results "
        "are exactly the structured plane's semantics; only the "
        "kernel-speed expectation is off.",
        stacklevel=3)


def warn_debug_demotes_pallas(cfg: SimConfig) -> None:
    """cfg.debug on a packed-eligible config: the round kernels carry no
    host callback, so the packed loop unpacks its plane stack and reads
    the event's three sums after every round, where it otherwise reads
    one count (the JAX package packs and unpacks around the same kernels
    every round).  The results are the packed run's; the run is slower.
    Announced once per process, with the JAX package's text; cfg.record
    observes without that cost.  Every call ticks ``sim.demotion.debug``
    (one tick a demoting call)."""
    from .utils.metrics import REGISTRY
    REGISTRY.counter("sim.demotion.debug").inc()
    global _debug_demotion_warned
    if _debug_demotion_warned:
        return
    _debug_demotion_warned = True
    warnings.warn(
        "SimConfig(debug=True) demotes this fused-pallas-eligible config "
        "to the per-round XLA loop (host debug callbacks cannot run "
        "inside the packed kernels): results are bit-identical via the "
        "XLA samplers' own streams only where the paths share streams, "
        "and the run is substantially slower.  For non-perturbing "
        "per-round telemetry use SimConfig(record=True) — the flight "
        "recorder fills on-device inside the fused loop.",
        stacklevel=3)


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


def device_identity(device=None) -> tuple:
    """(platform, device kind) of the device a run uses, as the documents
    that record it name it: ("cpu", "cpu") on the CPU, as the JAX
    package's CPU backend names itself, and ("gpu", the card's name) on
    CUDA."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "cpu"
    return "gpu", torch.cuda.get_device_name(dev)


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError unless one of the port's loops serves
    cfg: only ``mesh_shape`` (sharded runs) is left."""
    if cfg.mesh_shape is not None:
        unported("mesh_shape (sharded runs)", "15")
    if not tally.pallas_round_active(cfg):
        gap = benor.round_gap(cfg)
        if gap is not None:
            unported(*gap)


def heartbeat_due(cfg: SimConfig, prev_round, next_round) -> bool:
    """True iff the progress heartbeat (cfg.heartbeat_rounds;
    meshscope/heartbeat.py) fires for a round cursor that moved
    prev_round -> next_round: the cursor crossed a multiple of the cadence
    (sim.py:174-186).  Host-side only, between slices, so the knob cannot
    change a run; the one rule every regime beats by."""
    h = cfg.heartbeat_rounds
    if h <= 0:
        return False
    return (int(next_round) // h) > (int(prev_round) // h)


def start_state(cfg: SimConfig, state: NetState) -> NetState:
    """The /start transition: live lanes set k=1."""
    k = torch.where(~state.killed, torch.ones_like(state.k), state.k)
    return NetState(x=state.x, decided=state.decided, k=k,
                    killed=state.killed)


def _unfused_slice(cfg, state, faults, seed, from_round, until_round,
                   recorder=None, witness=None, dyn=None):
    """The unfused round loop -> (next_round, state, then the filled
    recorder and witness buffer where cfg arms them).  The JAX package runs
    it on the device (lax.while_loop); here it runs on the host and reads
    the settled predicate once per round, with the same condition
    ``(r <= max_rounds) & ~all_settled & (r < until_round)``.  The buffers
    of an earlier slice are continued (copied); None starts fresh ones
    from ``state``.  kernel_telemetry counts work inside the round kernels,
    which this loop does not run: it adds nothing here, as in the JAX
    package.  Under cfg.debug every round emits its event after it
    (utils/tracing.py), in order.  ``dyn`` reaches every round
    (``benor.benor_round``)."""
    rec = wit = None
    if cfg.record:
        rec = (new_recorder(cfg, state) if recorder is None
               else recorder.clone())
    if cfg.witness:
        wit = new_witness(cfg, state) if witness is None else witness.clone()
    r = int(from_round)
    while r <= cfg.max_rounds and r < until_round and \
            not bool(benor.all_settled(state)):
        out = benor.benor_round(cfg, state, faults, seed, r, rec, wit, dyn)
        state = out if rec is None and wit is None else out[0]
        if cfg.debug:
            emit_round_event(state)
        r += 1
    return (r, state, *(b for b in (rec, wit) if b is not None))


def _slice(cfg, state, faults, from_round, until_round, recorder=None,
           witness=None):
    """The loop that serves cfg, from ``from_round`` up to (not including)
    ``until_round`` -> (next_round, state, *the armed buffers).  A
    packed-eligible config under cfg.debug is announced where every JAX
    entry point announces it, and runs the packed loop."""
    check_supported(cfg)
    packed = tally.pallas_round_active(cfg)
    if cfg.debug and packed:
        warn_debug_demotes_pallas(cfg)
    run = packed_round.run_packed_slice if packed else _unfused_slice
    return run(cfg, state, faults, cfg.seed, from_round, until_round,
               recorder, witness)


def run_consensus(cfg: SimConfig, state: NetState, faults: FaultSpec):
    """Run from /start to termination or the round cap on the device the
    state lives on -> (rounds_executed, final_state), then the filled
    flight recorder (cfg.record), witness buffer (cfg.witness) and, on the
    packed loop, the stage-counter accumulator (cfg.kernel_telemetry), in
    that order.  cfg.seed keys every stream exactly as
    ``jax.random.key(cfg.seed)`` keys the JAX package's.  A config that
    asks for the fused kernels (use_pallas_round / use_pallas_hist) on a
    plane they never serve — a structured delivery plane, omission or a
    partition — is announced once per process, as the JAX package's
    ``run_consensus_traced`` does."""
    return run_consensus_traced(cfg, state, faults)


def run_consensus_traced(cfg: SimConfig, state: NetState, faults: FaultSpec,
                         dyn: Optional[DynParams] = None):
    """The round loop with the dynamic parameters of a batched sweep
    (sim.py:286-342) -> what ``run_consensus`` returns.

    ``dyn`` (``state.DynParams`` of 0-dim tensors, or None) supplies F,
    the quorum, the committee knobs and the omission probability in place
    of cfg's, which keeps every shape and mode decision; the unfused loop
    runs it.  Where the work is shaped by the quorum — the round kernels,
    the fused samplers, the dense quorum mask — ``dyn`` raises
    ``ValueError`` with the JAX package's messages
    (``sweep.quorum_specialized`` keeps such configs out of dynamic
    buckets).  With ``dyn=None`` this is ``run_consensus``.  The JAX
    package's demotion warnings are given here, as there."""
    if dyn is not None and tally.pallas_round_active(cfg):
        raise ValueError(
            "dynamic-F tracing cannot drive the fused pallas round; "
            "bucket such configs statically (sweep.quorum_specialized)")
    if tally.pallas_requested(cfg):
        if delivery_plane(cfg) != "complete":
            warn_structured_demotes_pallas(cfg)
        if not tally.pallas_round_active(cfg) and \
                (cfg.drop_prob or cfg.partition is not None):
            warn_faults_demote_pallas(cfg)
    state = start_state(cfg, state)
    if dyn is None:
        r, *rest = _slice(cfg, state, faults, 1, cfg.max_rounds + 2)
    else:
        check_supported(cfg)
        r, *rest = _unfused_slice(cfg, state, faults, cfg.seed, 1,
                                  cfg.max_rounds + 2, dyn=dyn)
    return (r - 1, *rest)


def run_consensus_slice(cfg: SimConfig, state: NetState, faults: FaultSpec,
                        from_round: int, until_round: int, recorder=None,
                        witness=None):
    """At most ``until_round - from_round`` rounds of the loop ->
    (next_round, state, *the armed buffers, as run_consensus);
    ``next_round == from_round`` means no progress was possible (already
    settled or past the round cap).  Randomness keys on (seed, round,
    phase, trial, node), never on how the loop was entered, so a run in
    slices equals the one-shot run bit for bit, the recorder and witness
    passed from slice to slice included.  ``state`` is taken as given: the
    first slice of a run starts from ``start_state(cfg, state)``."""
    return _slice(cfg, state, faults, from_round, until_round, recorder,
                  witness)


def resume_consensus(cfg: SimConfig, state: NetState, faults: FaultSpec,
                     from_round: int, recorder=None, witness=None):
    """Re-enter the loop from a checkpointed round index -> (rounds_executed,
    final_state, *the armed buffers), rounds counted from round 1 as
    ``run_consensus`` counts them.  ``recorder`` / ``witness`` continue a
    checkpointed run's buffers; None starts fresh ones, whose row 0
    snapshots the re-entry state and whose rows before ``from_round`` stay
    zero."""
    r, *rest = _slice(cfg, state, faults, from_round, cfg.max_rounds + 2,
                      recorder, witness)
    return (r - 1, *rest)


def simulate(cfg: SimConfig, initial_values, faulty_list=None,
             faults: Optional[FaultSpec] = None, crash_rounds=None,
             device=None):
    """One-shot run: build state, run, return (rounds, state, faults).

    With the observability flags set, the filled recorder, witness buffer
    and (packed loop) stage counters follow, as from ``run_consensus``.
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
    rounds, final, *extras = run_consensus(cfg, state, faults)
    return (rounds, final, faults, *extras)
