"""Adaptive cliff search: coarse grid -> gradient-free bisection (port of
benor_tpu/atlas/search.py).

The driver composes the existing instruments and adds no execution
semantics of its own:

  * EVALUATOR: every generation (the coarse seeding grid, then one
    midpoint per still-active cliff) is ONE
    ``sweep.run_points_batched`` call, so a drop_prob or f generation is
    one dynamic bucket and a partition generation one static bucket per
    distinct heal spec.  Probes ride the sweep journal
    (``journal_path``): the search truncates the file once up front and
    every generation appends with ``resume=True``, so a killed search
    re-run with ``resume=True`` restores every completed generation's
    buckets from the journal and runs only the rest — the generation
    sequence is a pure function of the (deterministic) probe summaries.
  * DETECTION: a cliff is a discontinuity of the chosen metric
    (``stall_frac`` — 1 - decided_frac — or ``rounds_executed``)
    between ADJACENT grid values; bisection keeps the half-interval
    containing the larger metric gap until the bracket is at the axis's
    pinned tolerance.
  * ORACLE/FORENSICS: each refined cliff's stalled/violating endpoint
    is re-run witness-armed through ``results._witness_rerun`` (the
    audit verdict separates liveness-only boundaries from safety
    breaks) and shrunk into a replayable ``kind: atlas_repro``
    document (atlas/repro.py).

``kind: atlas_probe`` / ``kind: atlas_cliff`` records interleave with
the sweep journal's bucket records in the same JSON-lines file; the
sweep's resume reader skips foreign kinds.  A generation's
``compile_count`` is the engine's: kernel-library builds and loads
(0 on the CPU and in a warm process), where the JAX package counts one
executable a bucket.  The search ticks the JAX package's ``atlas.*``
counters of the metrics registry (probes, generations, cliffs, heatmap
probes).  Every entry runs on CUDA unless ``device`` names the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..sweep import run_points_batched
from ..utils import metrics
from . import CLIFF_KIND, HEATMAP_KIND, PROBE_KIND
from .scenario import ScenarioAxis, parse_axis

#: Default discontinuity thresholds per metric: a stall_frac jump of
#: 0.5 flips the majority verdict; a rounds_executed jump of 4 is the
#: smallest step the round-quantized liveness boundaries produce.
DEFAULT_JUMP = {"stall_frac": 0.5, "rounds_executed": 4.0}

#: Refinement-generation ceiling: 40 halvings cover any representable
#: bracket; a search that has not converged by then is a driver bug.
MAX_GENERATIONS = 40


def _verdict(stall_frac: float) -> str:
    return "stalled" if stall_frac >= 0.5 else "decided"


@dataclasses.dataclass
class Probe:
    """One evaluated axis value and its oracle-side summary."""

    value: float
    generation: int
    rounds_executed: int
    decided_frac: float
    stall_frac: float
    mean_k: float
    disagree_frac: float
    verdict: str

    def metric(self, name: str) -> float:
        return float(getattr(self, name))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Cliff:
    """One refined phase boundary: the bracketing interval the search
    narrowed to the axis tolerance, plus its forensic evidence."""

    axis: str
    metric: str
    lo: float
    hi: float
    lo_metric: float
    hi_metric: float
    lo_verdict: str
    hi_verdict: str
    generations: List[int]          # refinement generations (ids)
    probes: int                     # probes spent on this cliff
    compile_count: int              # compiles of those generations
    safety: Optional[Dict] = None   # witness-armed audit verdict
    repro: Optional[Dict] = None    # kind: atlas_repro document
    repro_reproduced: Optional[bool] = None

    @property
    def point(self) -> float:
        return (self.lo + self.hi) / 2.0

    @property
    def width(self) -> float:
        return self.hi - self.lo

    @property
    def jump(self) -> float:
        return abs(self.hi_metric - self.lo_metric)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(point=self.point, width=self.width, jump=self.jump)
        return d


@dataclasses.dataclass
class AtlasSearch:
    """One axis search: probes, per-generation compile accounting, and
    the refined cliffs."""

    axis: ScenarioAxis
    metric: str
    probes: List[Probe]
    cliffs: List[Cliff]
    generations: List[Dict]

    @property
    def probe_count(self) -> int:
        return len(self.probes)

    @property
    def compile_count(self) -> int:
        return sum(int(g["compile_count"]) for g in self.generations)

    def to_dict(self) -> Dict:
        return {"axis": self.axis.name, "spec": self.axis.spec,
                "tol": self.axis.tol, "metric": self.metric,
                "probes": [p.to_dict() for p in self.probes],
                "probe_count": self.probe_count,
                "generations": list(self.generations),
                "compile_count": self.compile_count,
                "cliffs": [c.to_dict() for c in self.cliffs]}


class _Evaluator:
    """The search's batched oracle: one generation = ONE
    run_points_batched call, journaled + compile-accounted."""

    def __init__(self, base_cfg, axis: ScenarioAxis, initial_values=None,
                 journal_path: Optional[str] = None, resume: bool = False,
                 verbose: bool = False, device=None):
        self.base_cfg = base_cfg
        self.axis = axis
        self.initial_values = initial_values
        self.journal_path = journal_path
        self.verbose = verbose
        self.device = device
        self.generations: List[Dict] = []
        self.probes: List[Probe] = []
        if journal_path and not resume:
            # one truncation up front; every generation then appends
            # with resume=True so a restarted search restores each
            # completed generation from its own bucket records
            with open(journal_path, "w"):
                pass

    def _faults_for(self):
        if self.axis.faults == "none":
            from ..state import FaultSpec
            T, N = self.base_cfg.trials, self.base_cfg.n_nodes
            return lambda cfg_f: FaultSpec.none(T, N)
        return None                # run_point's default crash policy

    def run(self, values: Sequence[float]) -> List[Probe]:
        gen = len(self.generations)
        cfgs = [self.axis.apply(self.base_cfg, v) for v in values]
        cb = run_points_batched(
            cfgs[0], cfgs, initial_values=self.initial_values,
            faults_for=self._faults_for(),
            journal_path=self.journal_path,
            resume=bool(self.journal_path), device=self.device)
        out: List[Probe] = []
        for v, pt in zip(values, cb.points):
            stall = 1.0 - pt.decided_frac
            out.append(Probe(
                value=float(v), generation=gen,
                rounds_executed=int(pt.rounds_executed),
                decided_frac=float(pt.decided_frac),
                stall_frac=float(stall), mean_k=float(pt.mean_k),
                disagree_frac=float(pt.disagree_frac),
                verdict=_verdict(stall)))
        self.generations.append({
            "generation": gen, "n_points": len(cfgs),
            "n_buckets": int(cb.n_buckets),
            "compile_count": int(cb.compile_count),
            "buckets_reused": sum(1 for r in cb.bucket_reused if r)})
        self.probes.extend(out)
        metrics.REGISTRY.counter("atlas.probes").inc(len(out))
        metrics.REGISTRY.counter("atlas.generations").inc()
        if self.journal_path:
            for p in out:
                metrics.append_jsonl(self.journal_path, {
                    "kind": PROBE_KIND, "axis": self.axis.name,
                    "generation": gen, "value": p.value,
                    "verdict": p.verdict, "stall_frac": p.stall_frac,
                    "decided_frac": p.decided_frac,
                    "rounds_executed": p.rounds_executed})
        if self.verbose:
            shown = " ".join(f"{p.value:g}={p.verdict[0]}" for p in out)
            print(f"  atlas[{self.axis.name}] gen {gen}: {shown} "
                  f"({cb.n_buckets} bucket"
                  f"{'s' if cb.n_buckets != 1 else ''}, "
                  f"{cb.compile_count} compiles)", flush=True)
        return out


def _detect(probes: List[Probe], metric: str,
            jump: float) -> List[List[Probe]]:
    """Adjacent-pair discontinuities on a value-sorted probe list."""
    ordered = sorted(probes, key=lambda p: p.value)
    return [[a, b] for a, b in zip(ordered, ordered[1:])
            if abs(b.metric(metric) - a.metric(metric)) >= jump]


def _journal_cliff(ev: _Evaluator, axis: ScenarioAxis, metric: str,
                   lo: Probe, hi: Probe, converged: bool) -> None:
    if not ev.journal_path:
        return
    metrics.append_jsonl(ev.journal_path, {
        "kind": CLIFF_KIND, "axis": axis.name,
        "generation": len(ev.generations) - 1, "metric": metric,
        "lo": lo.value, "hi": hi.value, "width": hi.value - lo.value,
        "point": (lo.value + hi.value) / 2.0,
        "lo_verdict": lo.verdict, "hi_verdict": hi.verdict,
        "converged": bool(converged)})


def find_cliffs(base_cfg, axis: Union[str, ScenarioAxis],
                coarse: int = 6, metric: str = "stall_frac",
                jump: Optional[float] = None, initial_values=None,
                journal_path: Optional[str] = None, resume: bool = False,
                forensics: bool = False, out_dir: Optional[str] = None,
                verbose: bool = False, device=None) -> AtlasSearch:
    """Locate every ``metric`` discontinuity of ``axis`` over
    ``base_cfg`` to the axis's pinned tolerance.

    One coarse generation seeds the grid; each refinement generation
    batches the midpoints of ALL still-active brackets into one
    evaluator call.  With ``forensics=True`` each refined cliff gets a
    witness-armed audit of its stalled/violating side and a shrunk
    ``atlas_repro`` document (dumped under ``out_dir`` when given).
    """
    if metric not in DEFAULT_JUMP:
        raise ValueError(f"unknown cliff metric {metric!r}; choose "
                         f"from {sorted(DEFAULT_JUMP)}")
    axis = parse_axis(axis) if isinstance(axis, str) else axis
    jump = DEFAULT_JUMP[metric] if jump is None else float(jump)
    ev = _Evaluator(base_cfg, axis, initial_values=initial_values,
                    journal_path=journal_path, resume=resume,
                    verbose=verbose, device=device)
    ev.run(axis.grid(coarse))
    brackets = _detect(ev.probes, metric, jump)
    refined: List[Dict] = [
        {"lo": lo, "hi": hi, "generations": [], "probes": 2}
        for lo, hi in brackets]
    while len(ev.generations) <= MAX_GENERATIONS:
        active = [(b, axis.midpoint(b["lo"].value, b["hi"].value))
                  for b in refined]
        active = [(b, m) for b, m in active if m is not None]
        if not active:
            break
        probes = ev.run([m for _, m in active])
        gen = len(ev.generations) - 1
        for (b, _), mid in zip(active, probes):
            lo, hi = b["lo"], b["hi"]
            # keep the half with the larger metric gap — the jump
            # (whole or most of it) lives there
            if abs(mid.metric(metric) - lo.metric(metric)) >= \
                    abs(hi.metric(metric) - mid.metric(metric)):
                b["hi"] = mid
            else:
                b["lo"] = mid
            b["generations"].append(gen)
            b["probes"] += 1
            _journal_cliff(ev, axis, metric, b["lo"], b["hi"],
                           axis.converged(b["lo"].value, b["hi"].value))
    gen_compiles = {g["generation"]: int(g["compile_count"])
                    for g in ev.generations}
    cliffs = [Cliff(axis=axis.name, metric=metric,
                    lo=b["lo"].value, hi=b["hi"].value,
                    lo_metric=b["lo"].metric(metric),
                    hi_metric=b["hi"].metric(metric),
                    lo_verdict=b["lo"].verdict,
                    hi_verdict=b["hi"].verdict,
                    generations=list(b["generations"]),
                    probes=int(b["probes"]),
                    compile_count=sum(gen_compiles[g]
                                      for g in b["generations"]))
              for b in refined]
    metrics.REGISTRY.counter("atlas.cliffs").inc(len(cliffs))
    search = AtlasSearch(axis=axis, metric=metric, probes=ev.probes,
                         cliffs=cliffs, generations=ev.generations)
    if forensics:
        for cliff in cliffs:
            cliff_forensics(base_cfg, axis, cliff,
                            initial_values=initial_values,
                            out_dir=out_dir, verbose=verbose, device=device)
    return search


def cliff_forensics(base_cfg, axis: ScenarioAxis, cliff: Cliff,
                    initial_values=None, out_dir: Optional[str] = None,
                    verbose: bool = False, device=None) -> Cliff:
    """Witness-armed audit + minimal repro for one refined cliff.

    The stalled (or, for a pure rounds cliff, upper) endpoint is the
    interesting side: it is re-run through ``results._witness_rerun``
    (bit-identical witness-armed rerun + Ben-Or invariant audit — a
    clean verdict on a stalled side is the liveness-NOT-safety proof)
    and shrunk into a replayable ``atlas_repro`` whose replay verdict
    is stamped on the cliff (the gate's staleness signal)."""
    from .. import results
    from ..sim import resolve_device
    from ..sweep import default_crash_faults, random_inputs
    from . import repro as repro_mod

    dev = resolve_device(device)
    side = cliff.hi if cliff.hi_verdict == "stalled" or \
        cliff.hi_metric >= cliff.lo_metric else cliff.lo
    cfg = axis.apply(base_cfg, side)
    tag = f"atlas_{axis.name}_{side:g}"
    if initial_values is None:
        initial_values = random_inputs(cfg.seed, cfg.trials, cfg.n_nodes)
        inputs_policy = "random"
    else:
        iv = np.asarray(initial_values)
        inputs_policy = "ones" if bool((iv == 1).all()) else "balanced"
    faults = repro_mod._faults_for(cfg, axis.faults, dev)
    if faults is None:
        faults = default_crash_faults(cfg, dev)
    wa = results._witness_rerun(cfg, initial_values, faults, tag,
                                out_dir=out_dir, verbose=verbose, device=dev)
    cliff.safety = {
        "audit_ok": bool(wa["audit_ok"]),
        "n_violations": int(wa["n_violations"]),
        "liveness_only": bool(wa["audit_ok"])
        and cliff.hi_verdict == "stalled"}
    doc = repro_mod.build_repro(cfg, inputs=inputs_policy,
                                faults=axis.faults, label=tag, device=dev)
    cliff.repro = doc
    cliff.repro_reproduced = bool(repro_mod.replay_repro(doc, dev)["ok"])
    if out_dir:
        repro_mod.save_repro(
            f"{out_dir}/repro_{tag}.json".replace("//", "/"), doc)
    return cliff


def heatmap_slice(base_cfg, axis_a: Union[str, ScenarioAxis],
                  axis_b: Union[str, ScenarioAxis], na: int = 6,
                  nb: int = 4, initial_values=None,
                  journal_path: Optional[str] = None,
                  verbose: bool = False, device=None) -> Dict:
    """Evaluate one 2D slice (axis_a x axis_b cross product) in ONE
    batched call -> a ``kind: atlas_heatmap`` document of
    rounds-to-decide / stall-frac rows."""
    axis_a = parse_axis(axis_a) if isinstance(axis_a, str) else axis_a
    axis_b = parse_axis(axis_b) if isinstance(axis_b, str) else axis_b
    va, vb = axis_a.grid(na), axis_b.grid(nb)
    cfgs, pairs = [], []
    for b in vb:
        for a in va:
            cfgs.append(axis_b.apply(axis_a.apply(base_cfg, a), b))
            pairs.append((a, b))
    faults_for = None
    if "none" in (axis_a.faults, axis_b.faults):
        from ..state import FaultSpec
        T, N = base_cfg.trials, base_cfg.n_nodes
        faults_for = lambda cfg_f: FaultSpec.none(T, N)  # noqa: E731
    cb = run_points_batched(cfgs[0], cfgs,
                            initial_values=initial_values,
                            faults_for=faults_for, verbose=verbose,
                            device=device)
    rows = [{"a": a, "b": b,
             "rounds_executed": int(pt.rounds_executed),
             "decided_frac": float(pt.decided_frac),
             "stall_frac": float(1.0 - pt.decided_frac),
             "mean_k": float(pt.mean_k)}
            for (a, b), pt in zip(pairs, cb.points)]
    metrics.REGISTRY.counter("atlas.heatmap.probes").inc(len(rows))
    doc = {"kind": HEATMAP_KIND, "axis_a": axis_a.name,
           "axis_b": axis_b.name, "spec_a": axis_a.spec,
           "spec_b": axis_b.spec, "values_a": va, "values_b": vb,
           "rows": rows, "n_buckets": int(cb.n_buckets),
           "compile_count": int(cb.compile_count)}
    if journal_path:
        metrics.append_jsonl(journal_path, doc)
    return doc


def export_heatmap(doc: Dict, json_path: Optional[str] = None,
                   trace_path: Optional[str] = None) -> None:
    """Export a heatmap document: JSON rows (atomic write) and/or
    Perfetto counter tracks — one counter track per axis_b value,
    sampled along axis_a, so the cliff is visible as a step in the
    Perfetto UI's counter lane."""
    if json_path:
        metrics._atomic_write(json_path,
                              json.dumps(doc, indent=1, sort_keys=True))
    if trace_path:
        ev = []
        for i, row in enumerate(doc["rows"]):
            name = (f"atlas.{doc['axis_a']}"
                    f"[{doc['axis_b']}={row['b']:g}]")
            ev.append({"name": name, "ph": "C", "pid": 0,
                       "tid": "atlas", "ts": i * 1000,
                       "args": {"stall_frac": row["stall_frac"],
                                "rounds": row["rounds_executed"]}})
        metrics._atomic_write(
            trace_path,
            json.dumps({"traceEvents": ev, "displayTimeUnit": "ms"}))


