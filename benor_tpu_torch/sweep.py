"""The science harness: parameter sweeps over the simulator (port of
benor_tpu/sweep.py).

The per-point surface — ``run_point`` (one Monte-Carlo batch, run once to
warm up and once timed), ``rounds_vs_f``, ``coin_comparison``,
``record_trajectory`` — and the batched engine, ``run_points_batched``
with its front doors ``run_curve_batched``, ``rounds_vs_f_batched`` and
``coin_comparison_batched``.  Every summary is reduced on the device
(``summarize_final``) and fetched as a few scalars and a histogram of
``max_rounds + 2`` counts.

The engine groups the points into buckets by ``sweep_bucket_key``, as the
JAX package does, so the bucket order, the journal's point indices and
its fingerprints are the JAX package's.  A static bucket (a config whose
work is shaped by the quorum: the round kernels, the fused samplers, the
exact tables, the dense top-k mask) runs ``sim.run_consensus`` on its one
config, the round kernels included.  A dynamic bucket runs each of its
points through ``sim.run_consensus_traced`` with the bucket's first config
and the point's ``DynParams``.  The JAX package runs a dynamic bucket as
one vmapped executable; eager PyTorch has no executable to share, so the
points run one after another, with the same per-point results (a settled
lane's rounds change nothing under the vmap).  Every point runs from
``base_cfg.seed``, as every JAX point runs from
``jax.random.key(base_cfg.seed)``; its fingerprint and ``SweepPoint``
keep its own config.

Compile accounting: no per-bucket program exists to compile.  A bucket's
build leg loads the kernel library where its configs launch kernels on
the card, and ``compile_count`` counts the library builds (an nvcc run)
and loads that leg made (``ops/_build.library_events``): 0 on the CPU and
in a process that has loaded it already.  ``compile_s`` is that leg's
time.

The sweep journal (sweepscope/journal.py), the per-bucket spans
(sweepscope/spans.py, emitted where ``utils.metrics.SPANS`` is enabled)
the build-ahead scheduler (sweep_async.py) and the progress heartbeat,
one beat a bucket under ``base_cfg.heartbeat_rounds`` > 0
(meshscope/heartbeat.py), are the JAX package's; ``mesh`` raises (ROADMAP
Queue A item 15).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import SimConfig, VAL0, VAL1, VALQ, unported
from .models.benor import benor_round
from .ops import _build, sampling, tally
from .ops import packed_round as pr
from .sim import (resolve_device, run_consensus, run_consensus_traced,
                  start_state)
from .state import (PACK_NODES_PER_WORD, DynParams, FaultSpec, NetState,
                    init_state)


@dataclasses.dataclass
class SweepPoint:
    """Summary of one (config, fault-count) Monte-Carlo batch."""

    n_nodes: int
    n_faulty: int
    trials: int
    coin_mode: str
    scheduler: str
    rounds_executed: int        # loop trip count (max over lanes)
    decided_frac: float         # healthy lanes that decided
    mean_k: float               # mean observed k among decided healthy lanes
    k_hist: np.ndarray          # int64[max_rounds+2] histogram of decided k
    ones_frac: float            # decided-1 fraction among decided healthy
    seconds: float              # wall-clock for the batch (after warm-up)
    trials_per_sec: float
    #: Fraction of trials whose decided healthy lanes hold both values.
    disagree_frac: float = 0.0
    #: Flight-recorder round history (cfg.record): int32
    #: [max_rounds + 1, state.REC_WIDTH]; None when record is off.
    round_history: Optional[np.ndarray] = None
    #: Witness trace (cfg.witness): int32
    #: [max_rounds + 1, W, k, state.WIT_WIDTH]; None when it is off.
    witness: Optional[np.ndarray] = None

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["k_hist"] = self.k_hist.tolist()
        if self.round_history is not None:
            d["round_history"] = self.round_history.tolist()
        if self.witness is not None:
            d["witness"] = self.witness.tolist()
        return d


def _sum_i32(x: torch.Tensor) -> torch.Tensor:
    """The sum of an integer tensor as XLA's int32 reduction gives it: the
    sum is taken in int64 and wrapped into int32, so past 2^31 it wraps to
    the JAX package's value.  At N = 1M x 32 and 64 rounds the sum of k
    over decided lanes stays below 2^31 (32M lanes x k <= 65 = 2.08e9)."""
    s = x.sum(dtype=torch.int64)
    return ((s + 2**31) % 2**32 - 2**31).to(torch.int32)


def summarize_final(final: NetState, faulty: torch.Tensor, max_rounds: int):
    """On-device reduction -> (decided_frac, mean_k, ones_frac, k_hist,
    disagree_frac) (sweep.py:76-93): four float32 0-dim tensors, computed
    as the JAX function does (int32 sums, float32 quotients), and int32
    [max_rounds + 2] counts of the decided healthy lanes by k, a k past
    the last bin dropped as ``jnp.bincount`` drops it."""
    healthy = ~faulty
    hd = final.decided & healthy
    n_hd = torch.clamp_min(_sum_i32(hd), 1).to(torch.float32)
    decided_frac = (_sum_i32(hd).to(torch.float32)
                    / torch.clamp_min(_sum_i32(healthy), 1)
                    .to(torch.float32))
    mean_k = _sum_i32(final.k * hd).to(torch.float32) / n_hd
    ones_frac = _sum_i32(hd & (final.x == VAL1)).to(torch.float32) / n_hd
    length = max_rounds + 2
    k_hist = torch.bincount(
        torch.where(hd, final.k, length).to(torch.int64).ravel(),
        minlength=length + 1)[:length].to(torch.int32)
    # per-trial agreement: decided healthy lanes holding both values in
    # one trial is a safety violation
    got0 = (hd & (final.x == VAL0)).any(dim=-1)
    got1 = (hd & (final.x == VAL1)).any(dim=-1)
    disagree_frac = (got0 & got1).to(torch.float32).mean()
    return decided_frac, mean_k, ones_frac, k_hist, disagree_frac


def _packed_round_step(cfg: SimConfig, state: NetState, faults: FaultSpec,
                       r: int) -> NetState:
    """One round of the round kernels between a pack and an unpack, as the
    JAX package's ``benor_round`` runs a packed-eligible config
    (benor.py:101-140)."""
    n = state.x.shape[-1]
    pack = pr.pack_state(cfg, state, faults.faulty)
    bounds = pr.pad_fault_rounds(cfg, faults,
                                 pack.shape[2] * PACK_NODES_PER_WORD)
    hist1 = pr.sent_hist_from_pack(cfg, pack, *bounds, r)
    new_pack = pr.packed_round(cfg, pack, cfg.seed, r, hist1, n,
                               pr.n_equiv_from_pack(cfg, pack), bounds)[0]
    return pr.unpack_state(new_pack, n)


def record_trajectory(cfg: SimConfig, state: NetState, faults: FaultSpec,
                      n_rounds: int):
    """Round-by-round aggregates (sweep.py:99-143): exactly ``n_rounds``
    rounds of ``benor_round`` from /start, no early exit, with five
    aggregates over healthy lanes after each -> (final_state, traj), traj
    a dict of float32 [n_rounds] tensors: ``decided`` (decided share),
    ``zeros`` / ``ones`` / ``qs`` (value shares among live healthy lanes)
    and ``disagree`` (the share of trials whose decided healthy lanes hold
    both values).  A packed-eligible config runs its rounds on the round
    kernels, as there.  Decided lanes freeze, so the final state equals
    ``run_consensus``'s whenever ``n_rounds`` covers its rounds (and
    decided lanes are frozen)."""
    healthy = ~faults.faulty
    n_healthy = torch.clamp_min(_sum_i32(healthy), 1).to(torch.float32)

    def aggregates(st: NetState) -> dict:
        live = healthy & ~st.killed
        n_live = torch.clamp_min(_sum_i32(live), 1).to(torch.float32)
        hd = st.decided & healthy
        got0 = (hd & (st.x == VAL0)).any(dim=-1)
        got1 = (hd & (st.x == VAL1)).any(dim=-1)
        return {
            "decided": _sum_i32(hd).to(torch.float32) / n_healthy,
            "zeros": _sum_i32(live & (st.x == VAL0)).to(torch.float32)
            / n_live,
            "ones": _sum_i32(live & (st.x == VAL1)).to(torch.float32)
            / n_live,
            "qs": _sum_i32(live & (st.x == VALQ)).to(torch.float32) / n_live,
            "disagree": (got0 & got1).to(torch.float32).mean(),
        }

    packed = tally.pallas_round_active(cfg)
    st = start_state(cfg, state)
    rows = []
    for r in range(1, n_rounds + 1):
        st = (_packed_round_step(cfg, st, faults, r) if packed
              else benor_round(cfg, st, faults, cfg.seed, r))
        rows.append(aggregates(st))
    traj = {k: torch.stack([row[k] for row in rows]) if rows
            else torch.zeros(0, dtype=torch.float32, device=st.x.device)
            for k in ("decided", "zeros", "ones", "qs", "disagree")}
    return st, traj


def default_crash_faults(cfg: SimConfig, device=None) -> FaultSpec:
    """The default fault policy (sweep.py:146-167): the first F lanes
    crash-faulty, or under ``fault_model='crash_recover'`` their
    down-intervals realized from the config's ``recovery`` spec
    (faults/recovery.py), so the mask derives from the config alone."""
    if cfg.fault_model == "crash_recover":
        from .faults.recovery import crash_recover_faults
        if cfg.recovery is None:
            raise ValueError(
                "fault_model='crash_recover' under the default fault "
                "policy needs SimConfig.recovery (the schedule spec); "
                "pass an explicit FaultSpec to decouple them")
        return crash_recover_faults(cfg, device)
    fl = np.zeros(cfg.n_nodes, bool)
    fl[:cfg.n_faulty] = True
    return FaultSpec.from_faulty_list(cfg, fl, device=device)


def point_from_raw(cfg_f: SimConfig, vals, seconds: float) -> SweepPoint:
    """One SweepPoint from a bucket's raw per-point outputs (sweep.py:170-193):
    (rounds, decided, mean_k, ones, k_hist, disagree[, recorder]
    [, witness]), live or from the journal alike."""
    r, dec, mk, ones, khist, dis, *rest = vals
    history = wit = None
    if cfg_f.record:
        history = np.asarray(rest.pop(0), np.int32)
    if cfg_f.witness:
        wit = np.asarray(rest.pop(0), np.int32)
    return SweepPoint(
        n_nodes=cfg_f.n_nodes, n_faulty=cfg_f.n_faulty,
        trials=cfg_f.trials, coin_mode=cfg_f.coin_mode,
        scheduler=cfg_f.scheduler, rounds_executed=int(r),
        decided_frac=float(dec), mean_k=float(mk),
        k_hist=np.asarray(khist).astype(np.int64),
        ones_frac=float(ones), seconds=seconds,
        trials_per_sec=(cfg_f.trials / seconds if seconds > 0
                        else float("inf")),
        disagree_frac=float(dis), round_history=history, witness=wit)


def random_inputs(seed: int, trials: int, n: int) -> np.ndarray:
    """Per-trial random initial bits — the standard MC input distribution."""
    return np.random.default_rng(seed).integers(
        0, 2, size=(trials, n), dtype=np.int8)


def balanced_inputs(trials: int, n: int) -> np.ndarray:
    """Interleaved perfectly-balanced bits (node i starts with i mod 2)."""
    return np.tile((np.arange(n) % 2).astype(np.int8), (trials, 1))


def _barrier(device: torch.device) -> None:
    """Wait for the device's queued work: the end of a timed window."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _raw(cfg: SimConfig, out, faults: FaultSpec) -> list:
    """A run's outputs -> the device-side raw point: (rounds, the five
    summaries, then the recorder and the witness where cfg arms them)."""
    r, final, *extras = out
    return [r, *summarize_final(final, faults.faulty, cfg.max_rounds),
            *extras[:int(cfg.record) + int(cfg.witness)]]


def _fetch(raw: list) -> list:
    """A device-side raw point -> host values (numpy)."""
    return [raw[0]] + [v.cpu().numpy() for v in raw[1:]]


def run_point(cfg: SimConfig, initial_values=None, faulty_list=None,
              faults: Optional[FaultSpec] = None,
              device=None) -> SweepPoint:
    """Run one MC batch to termination -> its on-device summary
    (sweep.py:211-259).  Defaults: per-trial random initial bits, the first
    F nodes faulty; ``faults`` decouples the protocol parameter F from the
    crashes.  The run is made once to warm up and once timed, the timed
    window closing after the device has finished."""
    dev = resolve_device(device)
    if initial_values is None:
        initial_values = random_inputs(cfg.seed, cfg.trials, cfg.n_nodes)
    if faults is None:
        if faulty_list is None:
            faults = default_crash_faults(cfg, dev)
        else:
            faults = FaultSpec.from_faulty_list(cfg, faulty_list, device=dev)
    else:
        faults = faults.to(dev)
    state = init_state(cfg, initial_values, faults)
    run_consensus(cfg, state, faults)
    _barrier(dev)
    t0 = time.perf_counter()
    out = run_consensus(cfg, state, faults)
    _barrier(dev)
    seconds = time.perf_counter() - t0
    return point_from_raw(cfg, _fetch(_raw(cfg, out, faults)), seconds)


def rounds_vs_f(base_cfg: SimConfig, f_values: Sequence[int],
                verbose: bool = True, device=None) -> List[SweepPoint]:
    """The north-star curve: expected rounds-to-decide as F grows, one
    ``run_point`` a value of ``base_cfg.replace(n_faulty=f)``."""
    points = []
    for f in f_values:
        pt = run_point(base_cfg.replace(n_faulty=int(f)), device=device)
        points.append(pt)
        if verbose:
            print(f"  f={f}: mean_k={pt.mean_k:.2f} "
                  f"decided={pt.decided_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    return points


# --------------------------------------------------------------------------
# The batched engine: points grouped into buckets (sweep.py:280-416).
# --------------------------------------------------------------------------


def quorum_specialized(cfg: SimConfig) -> bool:
    """True iff this config's work is shaped by n_faulty — the round
    kernels, the fused samplers, the dense top-k mask, the exact tables —
    so it gets a static bucket of its own (sweep.py:303-336)."""
    if tally.pallas_stream_active(cfg) or tally.pallas_round_active(cfg):
        return True
    if cfg.drop_prob or cfg.partition is not None:
        # omission thinning and partition group histograms are not shaped
        # by the quorum (drop_prob is itself a DynParams axis)
        return False
    if (cfg.delivery == "quorum" and cfg.resolved_path == "dense"
            and cfg.scheduler not in ("adversarial", "targeted")):
        return True                 # top-k delivery mask
    if (cfg.delivery == "quorum" and cfg.resolved_path == "histogram"
            and cfg.scheduler in ("uniform", "biased")
            and cfg.quorum <= sampling.EXACT_TABLE_MAX):
        return True                 # exact shared-CDF table: [T, m + 1]
    if (cfg.fault_model == "equivocate" and cfg.delivery == "all"
            and cfg.topology is None
            and cfg.n_faulty <= sampling.EXACT_TABLE_MAX):
        return True                 # exact binomial table: [T, F + 1]
    return False


def sweep_bucket_key(cfg: SimConfig):
    """Hashable bucket token (sweep.py:339-359): two points share a bucket
    iff their keys are equal.  Quorum-specialized points key on the whole
    config; the rest on the config with the dynamic axes erased —
    n_faulty always, the committee count and size under committee
    delivery, drop_prob (to a 0.5 sentinel) under omission."""
    if quorum_specialized(cfg):
        return ("static", cfg)
    erase = {"n_faulty": 0}
    if cfg.committee_cap:
        erase.update(committee_count=1, committee_size=1)
    if cfg.drop_prob:
        erase.update(drop_prob=0.5)
    return ("dyn", cfg.replace(**erase))


@dataclasses.dataclass
class BatchedCurve:
    """A batched run plus its per-bucket accounting (sweep.py:362-416).
    The ``bucket_*`` lists are in bucket order; journal-restored buckets
    carry their journaled stage clocks there and add nothing to
    ``compile_s`` / ``run_s``."""

    points: List[SweepPoint]        # input order, same fields as run_point
    n_buckets: int
    bucket_sizes: List[int]
    #: kernel-library builds and loads the build legs made (module
    #: docstring); 0 on the CPU and in a warm process
    compile_count: int
    compile_s: float                # wall of the build legs' library step
    run_s: float                    # wall of running and fetching them
    bucket_prepare_s: List[float] = dataclasses.field(default_factory=list)
    bucket_compile_s: List[float] = dataclasses.field(default_factory=list)
    bucket_run_s: List[float] = dataclasses.field(default_factory=list)
    bucket_fetch_s: List[float] = dataclasses.field(default_factory=list)
    bucket_kinds: List[str] = dataclasses.field(default_factory=list)
    #: input-order point indices each bucket carried
    bucket_point_indices: List[List[int]] = dataclasses.field(
        default_factory=list)
    #: builds and loads per bucket this run (0 for restored)
    bucket_compile_counts: List[int] = dataclasses.field(
        default_factory=list)
    #: True where the bucket was reassembled from the sweep journal
    bucket_reused: List[bool] = dataclasses.field(default_factory=list)
    #: wall clock of the whole call
    wall_s: float = 0.0
    #: wall an ideal build-ahead pipeline would reclaim (sweepscope/gate.py)
    overlap_headroom_s: float = 0.0
    #: True when the buckets ran under the build-ahead scheduler
    pipelined: bool = False
    #: wall of the bucket loop alone
    span_s: float = 0.0
    #: headroom reclaimed against the strictly serial stage schedule
    headroom_reclaimed_s: float = 0.0
    #: always None on the port (mesh placement is ROADMAP item 15)
    mesh_shape: Optional[List[int]] = None


def run_curve_batched(base_cfg: SimConfig, f_values: Sequence[int],
                      initial_values=None, faults_for=None,
                      verbose: bool = False,
                      heartbeat_path: Optional[str] = None,
                      journal_path: Optional[str] = None,
                      resume: bool = False, pipeline: bool = False,
                      mesh=None, device=None) -> BatchedCurve:
    """A rounds-vs-f curve through the batched engine: each f value becomes
    ``base_cfg.replace(n_faulty=f)`` (sweep.py:432-452)."""
    cfgs = [base_cfg.replace(n_faulty=int(f)) for f in f_values]
    return run_points_batched(base_cfg, cfgs,
                              initial_values=initial_values,
                              faults_for=faults_for, verbose=verbose,
                              heartbeat_path=heartbeat_path,
                              journal_path=journal_path, resume=resume,
                              pipeline=pipeline, mesh=mesh, device=device)


def run_points_batched(base_cfg: SimConfig, cfgs: Sequence[SimConfig],
                       initial_values=None, faults_for=None,
                       verbose: bool = False,
                       heartbeat_path: Optional[str] = None,
                       journal_path: Optional[str] = None,
                       resume: bool = False, pipeline: bool = False,
                       mesh=None, device=None) -> BatchedCurve:
    """Run a list of per-point configs bucket by bucket (sweep.py:455-872).

    Every point shares base_cfg's (trials, n_nodes) and runs from
    ``base_cfg.seed``; ``initial_values`` defaults to
    ``random_inputs(base_cfg.seed, T, N)``; ``faults_for(cfg_f) ->
    FaultSpec`` builds each point's faults (default
    ``default_crash_faults``).  The per-point summaries equal the
    per-point loop's.  A point's ``seconds`` is its bucket's run and fetch
    time divided by the bucket's size.

    ``journal_path`` appends one record per completed bucket;
    ``resume=True`` rebuilds every bucket whose fingerprint and point
    indices match a record from the journal, running nothing for it.
    ``pipeline=True`` builds bucket k + 1 on a worker thread while bucket
    k runs (sweep_async.py); results, counts and journal records equal the
    serial dispatch.  With ``base_cfg.heartbeat_rounds`` > 0 a progress
    heartbeat (points done / points total) is published after every
    bucket, in bucket order, into the metrics registry and, when
    ``heartbeat_path`` is given, a JSON-lines file that ``watch`` tails;
    the points are unchanged.  ``mesh`` raises ``NotImplementedError``
    (ROADMAP Queue A item 15)."""
    from .sweepscope import gate as sweep_gate
    from .sweepscope.journal import (SweepJournal, bucket_fingerprint,
                                     deserialize_point, serialize_point)
    from .sweepscope.spans import emit_bucket_spans

    t_wall0 = time.perf_counter()
    T, N = base_cfg.trials, base_cfg.n_nodes
    for cfg_f in cfgs:
        if (cfg_f.trials, cfg_f.n_nodes) != (T, N):
            raise ValueError(
                "run_points_batched points must share base_cfg's "
                f"(trials, n_nodes)=({T}, {N}); got "
                f"({cfg_f.trials}, {cfg_f.n_nodes})")
    if resume and journal_path is None:
        raise ValueError("resume=True requires journal_path (the "
                         "journal IS the resume substrate)")
    if mesh is not None:
        unported("mesh (the sweep's grid placement)", "15")
    dev = resolve_device(device)
    if initial_values is None:
        initial_values = random_inputs(base_cfg.seed, T, N)
    faults_fn = (faults_for if faults_for is not None
                 else functools.partial(default_crash_faults, device=dev))

    cfgs = list(cfgs)
    buckets: Dict = {}
    order: List = []
    for i, cfg_f in enumerate(cfgs):
        key = sweep_bucket_key(cfg_f)
        if key not in buckets:
            buckets[key] = {"idx": [], "cfgs": []}
            order.append(key)
        buckets[key]["idx"].append(i)
        buckets[key]["cfgs"].append(cfg_f)
    journal = (SweepJournal(journal_path, resume=resume)
               if journal_path is not None else None)

    raw = [None] * len(cfgs)
    secs = [0.0] * len(cfgs)
    compile_s = run_s = 0.0
    total_compiles = 0
    bucket_sizes: List[int] = []
    stage_prepare: List[float] = []
    stage_compile: List[float] = []
    stage_run: List[float] = []
    stage_fetch: List[float] = []
    bucket_kinds: List[str] = []
    bucket_indices: List[List[int]] = []
    bucket_compiles: List[int] = []
    bucket_reused: List[bool] = []
    heartbeat = None
    if base_cfg.heartbeat_rounds:
        from .meshscope.heartbeat import (HeartbeatPublisher,
                                          publish_sweep_heartbeat)
        heartbeat = HeartbeatPublisher(base_cfg, path=heartbeat_path,
                                       label="sweep")
    points_done = 0

    def build_bucket(bi, key, b):
        """Bucket k's build leg: fault specs, fingerprint and journal match,
        then for a bucket that will run its state tensors and the kernel
        library.  Under ``pipeline=True`` it runs on the worker thread."""
        # every point runs from base_cfg's seed; the point keeps its config
        rep = b["cfgs"][0].replace(seed=base_cfg.seed)
        t_prep0 = time.perf_counter()
        faults = [faults_fn(c) for c in b["cfgs"]]
        rec = None
        if journal is not None:
            b["fp"] = bucket_fingerprint(b["cfgs"], initial_values, faults)
            if resume:
                rec = journal.match(b["fp"], b["idx"])
        if rec is not None:
            return {"bi": bi, "key": key, "b": b, "rec": rec,
                    "t_prep0": t_prep0,
                    "restore_s": time.perf_counter() - t_prep0}
        faults = [fl.to(dev) for fl in faults]
        if key[0] == "dyn":
            states = [init_state(c, initial_values, fl)
                      for c, fl in zip(b["cfgs"], faults)]
            dyn = DynParams.stack(b["cfgs"], dev)
            args = (states, faults, dyn)
        else:
            # one config: its points share one run
            args = (init_state(b["cfgs"][0], initial_values, faults[0]),
                    faults[0])
        prepare_s = time.perf_counter() - t_prep0
        t0 = time.perf_counter()
        events0 = _build.library_events
        if dev.type == "cuda" and any(tally.kernels_active(c)
                                      for c in b["cfgs"]):
            _build.load_library()
        return {"bi": bi, "key": key, "b": b, "rec": None, "rep": rep,
                "args": args, "t_prep0": t_prep0, "prepare_s": prepare_s,
                "compile_s": time.perf_counter() - t0,
                "compiles": _build.library_events - events0}

    def execute_bucket(plan):
        """Bucket k's ordered leg, on the caller's thread: run, fetch,
        journal record, heartbeat, verbose line."""
        nonlocal compile_s, run_s, total_compiles, points_done
        bi, key, b, rec = plan["bi"], plan["key"], plan["b"], plan["rec"]
        bucket_sizes.append(len(b["idx"]))
        bucket_kinds.append(key[0])
        bucket_indices.append(list(b["idx"]))
        if rec is not None:
            # journal restore through the same point_from_raw path; nothing
            # is built or run
            share = (float(rec.get("run_s") or 0.0)
                     + float(rec.get("fetch_s") or 0.0)) / len(b["idx"])
            for j, i in enumerate(b["idx"]):
                raw[i] = deserialize_point(b["cfgs"][j], rec["points"][j])
                secs[i] = share
            stage_prepare.append(float(rec.get("prepare_s") or 0.0))
            stage_compile.append(float(rec.get("compile_s") or 0.0))
            stage_run.append(float(rec.get("run_s") or 0.0))
            stage_fetch.append(float(rec.get("fetch_s") or 0.0))
            bucket_compiles.append(0)
            bucket_reused.append(True)
            journal.reused += 1
            emit_bucket_spans(bi, key[0], b["idx"], b["cfgs"],
                              {"restore": (plan["t_prep0"],
                                           plan["restore_s"])},
                              reused=True)
        else:
            rep = plan["rep"]
            t0 = time.perf_counter()
            if key[0] == "dyn":
                states, faults, dyn = plan["args"]
                outs = [_raw(rep, run_consensus_traced(rep, st, fl,
                                                       dyn.at(j)), fl)
                        for j, (st, fl) in enumerate(zip(states, faults))]
            else:
                state, fl = plan["args"]
                outs = [_raw(rep, run_consensus(rep, state, fl), fl)]
            _barrier(dev)
            bucket_run_s = time.perf_counter() - t0
            plan["args"] = None
            t0 = time.perf_counter()
            outs = [_fetch(o) for o in outs]
            for j, i in enumerate(b["idx"]):
                raw[i] = outs[j if key[0] == "dyn" else 0]
            bucket_fetch_s = time.perf_counter() - t0
            for i in b["idx"]:
                secs[i] = (bucket_run_s + bucket_fetch_s) / len(b["idx"])
            compile_s += plan["compile_s"]
            run_s += bucket_run_s + bucket_fetch_s
            total_compiles += plan["compiles"]
            stage_prepare.append(plan["prepare_s"])
            stage_compile.append(plan["compile_s"])
            stage_run.append(bucket_run_s)
            stage_fetch.append(bucket_fetch_s)
            bucket_compiles.append(plan["compiles"])
            bucket_reused.append(False)
            t_prep0, prepare_s = plan["t_prep0"], plan["prepare_s"]
            t_exec0 = t_prep0 + prepare_s + plan["compile_s"]
            emit_bucket_spans(
                bi, key[0], b["idx"], b["cfgs"],
                {"prepare": (t_prep0, prepare_s),
                 "compile": (t_prep0 + prepare_s, plan["compile_s"]),
                 "execute": (t_exec0, bucket_run_s),
                 "fetch": (t_exec0 + bucket_run_s, bucket_fetch_s)})
            if journal is not None:
                journal.record_bucket(
                    bi, key[0], b["idx"], b["fp"], plan["compiles"],
                    {"prepare_s": plan["prepare_s"],
                     "compile_s": plan["compile_s"],
                     "run_s": bucket_run_s, "fetch_s": bucket_fetch_s},
                    [serialize_point(c, raw[i])
                     for c, i in zip(b["cfgs"], b["idx"])],
                    pipelined=pipeline)
        points_done += len(b["idx"])
        if heartbeat is not None:
            publish_sweep_heartbeat(base_cfg, points_done, len(cfgs),
                                    publisher=heartbeat, bucket_index=bi)
        if verbose:
            if rec is not None:
                detail = "journal-restored"
            else:
                detail = (f"compile {stage_compile[-1]:.2f}s, "
                          f"run {stage_run[-1] + stage_fetch[-1]:.2f}s")
            print(f"  bucket {bi + 1}/{len(order)} [{key[0]}] "
                  f"{len(b['idx'])} point(s): {detail}", flush=True)

    work = [(bi, key, buckets[key]) for bi, key in enumerate(order)]
    t_span0 = time.perf_counter()
    if pipeline:
        from .sweep_async import pipeline_buckets
        for plan in pipeline_buckets(work, build_bucket):
            execute_bucket(plan)
    else:
        for bi, key, b in work:
            execute_bucket(build_bucket(bi, key, b))
    span_s = time.perf_counter() - t_span0
    del work, buckets

    points = [point_from_raw(cfg_f, vals, s)
              for cfg_f, vals, s in zip(cfgs, raw, secs)]
    stage_dicts = [
        {"prepare_s": p, "compile_s": c, "run_s": r, "fetch_s": f}
        for p, c, r, f in zip(stage_prepare, stage_compile, stage_run,
                              stage_fetch)]
    headroom = sweep_gate.overlap_headroom_s(stage_dicts)
    cb = BatchedCurve(points=points, n_buckets=len(order),
                      bucket_sizes=bucket_sizes,
                      compile_count=total_compiles,
                      compile_s=compile_s, run_s=run_s,
                      bucket_prepare_s=stage_prepare,
                      bucket_compile_s=stage_compile,
                      bucket_run_s=stage_run,
                      bucket_fetch_s=stage_fetch,
                      bucket_kinds=bucket_kinds,
                      bucket_point_indices=bucket_indices,
                      bucket_compile_counts=bucket_compiles,
                      bucket_reused=bucket_reused,
                      wall_s=time.perf_counter() - t_wall0,
                      overlap_headroom_s=headroom,
                      pipelined=bool(pipeline), span_s=span_s,
                      headroom_reclaimed_s=sweep_gate.headroom_reclaimed_s(
                          stage_dicts, span_s))
    if journal is not None:
        journal.record_done(len(cfgs), len(order), headroom)
    if verbose:
        totals = [p + c + r + f
                  for p, c, r, f in zip(stage_prepare, stage_compile,
                                        stage_run, stage_fetch)]
        share = max(totals) / sum(totals) if sum(totals) > 0 else 0.0
        reused_note = (f", {sum(bucket_reused)} journal-restored"
                       if any(bucket_reused) else "")
        pipe_note = (f", pipelined: reclaimed "
                     f"{cb.headroom_reclaimed_s:.2f}s" if pipeline else "")
        print(f"  batched curve: {len(cfgs)} points / {cb.n_buckets} "
              f"bucket(s), {cb.compile_count} compiles "
              f"({cb.compile_s:.1f}s), run {cb.run_s:.2f}s; max bucket "
              f"share {100 * share:.0f}%, overlap headroom "
              f"{cb.overlap_headroom_s:.2f}s{pipe_note}{reused_note}",
              flush=True)
    return cb


def rounds_vs_f_batched(base_cfg: SimConfig, f_values: Sequence[int],
                        verbose: bool = True,
                        heartbeat_path: Optional[str] = None,
                        journal_path: Optional[str] = None,
                        resume: bool = False,
                        device=None) -> List[SweepPoint]:
    """The north-star curve through the batched engine, with
    ``rounds_vs_f``'s defaults and summaries (sweep.py:880-896)."""
    cb = run_curve_batched(base_cfg, f_values, verbose=verbose,
                           heartbeat_path=heartbeat_path,
                           journal_path=journal_path, resume=resume,
                           device=device)
    if verbose:
        for pt in cb.points:
            print(f"  f={pt.n_faulty}: mean_k={pt.mean_k:.2f} "
                  f"decided={pt.decided_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    return cb.points


def coin_comparison_batched(base_cfg: SimConfig, f_values: Sequence[int],
                            verbose: bool = True, device=None
                            ) -> Dict[str, List[SweepPoint]]:
    """``coin_comparison`` over an f-axis (sweep.py:899-926): each coin's
    curve through the batched engine, balanced inputs, zero crashes, an
    even quorum required at every point."""
    T, N = base_cfg.trials, base_cfg.n_nodes
    for f in f_values:
        if (N - int(f)) % 2:
            raise ValueError(
                f"coin_comparison needs an even quorum N-F for a "
                f"perfect-tie adversary (got N-F={N - int(f)} at f={f}); "
                f"adjust N or the f grid")
    balanced = balanced_inputs(T, N)
    out: Dict[str, List[SweepPoint]] = {}
    for coin in ("private", "common"):
        cfg = base_cfg.replace(coin_mode=coin, scheduler="adversarial",
                               delivery="quorum")
        if verbose:
            print(f" coin_mode={coin}:", flush=True)
        cb = run_curve_batched(
            cfg, f_values, initial_values=balanced,
            faults_for=lambda c: FaultSpec.none(T, N), verbose=verbose,
            device=device)
        out[coin] = cb.points
    return out


def coin_comparison(base_cfg: SimConfig, verbose: bool = True,
                    device=None) -> Dict[str, List[SweepPoint]]:
    """Private against common coin under the count-controlling adversary
    (sweep.py:929-970): all N nodes alive, balanced inputs, a tied
    delivered multiset every round, which needs an even quorum N - F.  The
    private coin livelocks where F >> sqrt(N); the common coin escapes in
    O(1) rounds."""
    if base_cfg.quorum % 2:
        raise ValueError(
            f"coin_comparison needs an even quorum N-F for a perfect-tie "
            f"adversary (got N-F={base_cfg.quorum}); adjust N or F")
    T, N = base_cfg.trials, base_cfg.n_nodes
    no_crash = FaultSpec.none(T, N)
    balanced = balanced_inputs(T, N)
    out: Dict[str, List[SweepPoint]] = {}
    for coin in ("private", "common"):
        cfg = base_cfg.replace(coin_mode=coin, scheduler="adversarial",
                               delivery="quorum")
        if verbose:
            print(f" coin_mode={coin}:", flush=True)
        pt = run_point(cfg, initial_values=balanced, faults=no_crash,
                       device=device)
        if verbose:
            print(f"  decided={pt.decided_frac:.3f} mean_k={pt.mean_k:.2f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
        out[coin] = [pt]
    return out


def baseline_configs() -> Dict[str, SimConfig]:
    """The five BASELINE.json benchmark configs as ready-to-run presets."""
    return {
        # "Fault-free Ben-Or, N=5 nodes, random initial x"
        "n5_faultfree": SimConfig(n_nodes=5, n_faulty=0, trials=1024,
                                  delivery="quorum", scheduler="uniform"),
        # "Crash-fault Ben-Or, N=10k nodes, f=N/5 crash mask, 1k MC trials"
        "n10k_crash": SimConfig(n_nodes=10_000, n_faulty=2_000, trials=1000,
                                delivery="quorum", scheduler="uniform",
                                path="histogram"),
        # "Byzantine Ben-Or, N=100k nodes, f<N/5 adversarial bit-flip mask"
        "n100k_byzantine": SimConfig(n_nodes=100_000, n_faulty=19_999,
                                     trials=64, fault_model="byzantine",
                                     delivery="quorum", scheduler="uniform",
                                     path="histogram"),
        # "Private-coin vs shared-common-coin, N=1M, rounds-to-decide vs f"
        "n1m_coin_sweep": SimConfig(n_nodes=1_000_000, n_faulty=200_000,
                                    trials=32, delivery="quorum",
                                    scheduler="uniform", path="histogram"),
        # "Asynchronous adversarial scheduler, N=1M nodes"
        "n1m_adversarial": SimConfig(n_nodes=1_000_000, n_faulty=200_000,
                                     trials=32, delivery="quorum",
                                     scheduler="adversarial", max_rounds=24,
                                     path="histogram"),
    }


def save_points(path: str, points: Sequence[SweepPoint]) -> None:
    with open(path, "w") as fh:
        json.dump([p.to_dict() for p in points], fh, indent=1)
