"""The job API: JobSpec -> bucket -> batch slot -> result slice (port of
benor_tpu/serve/jobs.py).

The request plane (serve/server.py), the load generator (serve/loadgen.py),
the CLI (``python -m benor_tpu_torch serve`` / ``load``) and results.py's
``serve_replay`` documents consume it.  A ``JobSpec`` is the wire-level
description of one client request; validation turns it into a
``SimConfig`` plus run_point's default inputs (per-trial random bits
seeded by the job's seed, the first F lanes crash-faulty through
``sweep.default_crash_faults``), so that a job served through the request
plane equals the same config run through ``sweep.run_point``.

Job kinds (the four client verbs of the request plane):

  simulate    one MC batch -> its summary (a SweepPoint dict)
  sweep       a rounds-vs-f curve; expands into one simulate job per f
              value (each point is its own batch slot, so points from one
              client coalesce with other clients' points)
  trajectory  simulate with the flight recorder armed: the per-round rows
              stream back as server-sent events on the ``since_round``
              cursor
  audit       simulate with the witness armed at the
              audit.default_witness_overrides watch set; the Ben-Or
              invariants are checked on the host (audit.audit_witness) and
              the verdict rides the result

Validation errors raise ``JobError`` carrying a structured body, which the
server answers as a 400 word for word.  The documents, the rejections and
the stage model are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..config import SimConfig

#: JobSpec fields forwarded to SimConfig verbatim (everything else is
#: job-plane metadata); a pure literal, so the rejection messages cannot
#: drift.  ``topology`` and the committee knobs key ``serve_bucket_key``
#: through the whole config, so mismatched topologies never share a batch
#: while committee count and size coalesce as DynParams axes;
#: ``drop_prob`` coalesces as a DynParams axis too, while ``recovery`` /
#: ``partition`` specs are static config and separate buckets.
#: No ``use_pallas*`` flag is among them, as in the JAX package: a served
#: job runs the plain loops.
CONFIG_FIELDS = ("n_nodes", "n_faulty", "trials", "max_rounds", "rule",
                 "seed", "coin_mode", "coin_eps", "delivery", "scheduler",
                 "adversary_strength", "fault_model", "path", "topology",
                 "committee_cap", "committee_count", "committee_size",
                 "drop_prob", "recovery", "partition")

#: The four client verbs.
JOB_KINDS = ("simulate", "sweep", "trajectory", "audit")

#: servescope's NINE job stamps, in transition order (README Serving's
#: stage model).  Every stamp is a host-side ``time.perf_counter()``
#: float taken at the transition — the batcher owns accepted through
#: result_sliced and the terminal done; the HTTP front door refines the
#: stream leg (``first_sse`` = the first result-phase event written to
#: the client, and it re-stamps ``done`` when the job's whole SSE feed
#: has been written, so stream-out time is attributed to the job).
STAGE_STAMPS = ("accepted", "validated", "enqueued", "batch_assigned",
                "launch_start", "launch_end", "result_sliced",
                "first_sse", "done")

#: The stage-latency attribution: name -> (from_stamp, to_stamp).
#: Stages are CONSECUTIVE stamp pairs, so their durations TELESCOPE —
#: when every stamp is present, the stage sum equals done - accepted
#: exactly, which is what makes the manifest's attribution
#: cross-check (stage means vs client mean latency) an honest
#: completeness test instead of an approximation.  ``first_sse`` is a
#: sub-milestone INSIDE stream_out (reported by the timing route as
#: stream_wait/stream_flush when present) so that a polled, never-
#: streamed job still attributes its full result_sliced -> done time.
STAGES = (
    ("validate", "accepted", "validated"),
    ("enqueue", "validated", "enqueued"),
    ("queue_wait", "enqueued", "batch_assigned"),
    ("batch_assemble", "batch_assigned", "launch_start"),
    ("launch", "launch_start", "launch_end"),
    ("result_slice", "launch_end", "result_sliced"),
    ("stream_out", "result_sliced", "done"),
)

#: Stage names in stage order (the manifest's ``stages`` block keys).
STAGE_NAMES = tuple(name for name, _, _ in STAGES)

#: stream_out's optional subdivision at the first_sse milestone.
SUB_STAGES = (
    ("stream_wait", "result_sliced", "first_sse"),
    ("stream_flush", "first_sse", "done"),
)


def stage_durations(stamps: Dict[str, float]) -> Dict[str, float]:
    """Stamps -> per-stage seconds (only stages whose BOTH stamps are
    present; negatives clamped to zero — a stamp pair that raced, e.g.
    a server-side done refinement landing before a slow result slice,
    must never produce negative attribution)."""
    out: Dict[str, float] = {}
    for name, a, b in STAGES:
        if a in stamps and b in stamps:
            out[name] = max(0.0, stamps[b] - stamps[a])
    return out


def timing_dict(stamps: Dict[str, float]) -> Dict[str, Any]:
    """The ``/v1/jobs/<id>/timing`` payload: per-stage seconds, the
    stream sub-stages when the job streamed, each stamp relative to
    ``accepted`` (absolute perf_counter values are meaningless across
    processes), and the fully-attributed total.  Values are rounded to
    6 dp INDEPENDENTLY, so the telescoping identity holds to ~N*0.5e-6
    in the payload (exact on the raw stamps) — consumers comparing
    sum-of-stages to total_s must allow that rounding slack."""
    stages = stage_durations(stamps)
    subs = {name: max(0.0, stamps[b] - stamps[a])
            for name, a, b in SUB_STAGES
            if a in stamps and b in stamps}
    acc = stamps.get("accepted")
    rel = {k: round(stamps[k] - acc, 6) for k in STAGE_STAMPS
           if k in stamps} if acc is not None else {}
    total = None
    if acc is not None and "done" in stamps:
        total = round(stamps["done"] - acc, 6)
    return {
        "stages_s": {k: round(v, 6) for k, v in stages.items()},
        "sub_stages_s": {k: round(v, 6) for k, v in subs.items()},
        "stamps_rel_s": rel,
        "total_s": total,
    }

#: Per-job ceilings for the DEMO-scale request plane: one over-sized job
#: would occupy a whole bucket and starve the coalescing that makes
#: serving pay.  Operators running a private instance can lift them via
#: ServeApp(limits=...).
DEFAULT_LIMITS = {"n_nodes": 1 << 16, "trials": 1 << 12,
                  "max_rounds": 1 << 10, "f_values": 64,
                  # committee_cap sizes the [T, cap, 3] per-committee
                  # histogram — an uncapped value would let one job
                  # allocate a trials*cap-scale buffer
                  "committee_cap": 1 << 10}


class JobError(ValueError):
    """A rejected JobSpec: ``body`` is the structured 400 payload."""

    def __init__(self, field: str, reason: str):
        super().__init__(f"{field}: {reason}")
        self.body = {"error": "invalid job", "field": field,
                     "reason": reason}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One client job, as validated from the wire (``from_dict``)."""

    kind: str = "simulate"
    n_nodes: int = 64
    n_faulty: int = 0
    trials: int = 8
    max_rounds: int = 32
    rule: str = "reference"
    seed: int = 0
    coin_mode: str = "private"
    coin_eps: float = 0.0
    delivery: str = "all"
    scheduler: str = "uniform"
    adversary_strength: float = 0.0
    fault_model: str = "crash"
    path: str = "auto"
    #: structured delivery (topo/): an adjacency spec string
    #: ('complete' | 'ring:<d>' | 'torus2d:<r>x<c>' | 'expander:<d>' |
    #: 'random_regular:<d>[:seed]') or null, and the committee knobs.
    topology: Optional[str] = None
    committee_cap: int = 0
    committee_count: int = 0
    committee_size: int = 0
    #: faultlab (faults/): per-edge omission probability, the
    #: crash-recovery schedule spec ('at:<crash>:<down>[:amnesia|
    #: durable]' / 'stagger:...') and the partition spec
    #: ('halves:<heal>' / 'groups:<g>:<heal>') or null.
    drop_prob: float = 0.0
    recovery: Optional[str] = None
    partition: Optional[str] = None
    #: sweep kind only: the curve's f grid (expands to per-point jobs).
    f_values: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_dict(cls, doc: Any,
                  limits: Optional[Dict[str, int]] = None) -> "JobSpec":
        """Validate a wire document -> JobSpec, raising JobError (the
        structured 400) on anything malformed rather than letting a bad
        value poison the batch plane downstream."""
        # an operator's limits dict MERGES over the defaults: a partial
        # override ({"n_nodes": 1 << 20}) lifts one cap without
        # KeyErroring every submit on the ones it didn't mention
        limits = {**DEFAULT_LIMITS, **(limits or {})}
        if not isinstance(doc, dict):
            raise JobError("$", "job body must be a JSON object")
        unknown = sorted(set(doc) - set(CONFIG_FIELDS)
                         - {"kind", "f_values"})
        if unknown:
            raise JobError(unknown[0],
                           f"unknown field (accepted: kind, f_values, "
                           f"{', '.join(CONFIG_FIELDS)})")
        kind = doc.get("kind", "simulate")
        if kind not in JOB_KINDS:
            raise JobError("kind", f"must be one of {list(JOB_KINDS)}")
        kw: Dict[str, Any] = {"kind": kind}
        defaults = cls()
        for f in CONFIG_FIELDS:
            if f not in doc:
                continue
            v = doc[f]
            if f in ("topology", "recovery", "partition"):
                # Optional[str]: the generic type check below would key
                # on NoneType.  Spec-string VALIDITY (grammar, degree
                # bounds, N coverage, heal rounds) is SimConfig's parse
                # at the to_config() probe — those surface as structured
                # 400s on the 'config' field.
                if v is not None and not isinstance(v, str):
                    hints = {"topology": "a topology spec string (e.g. "
                                         "'torus2d:8x8')",
                             "recovery": "a recovery schedule spec (e.g. "
                                         "'stagger:2:3:amnesia')",
                             "partition": "a partition spec (e.g. "
                                          "'halves:6')"}
                    raise JobError(f, f"must be {hints[f]} or null")
                kw[f] = v
                continue
            want = type(getattr(defaults, f))
            if want is float and isinstance(v, int) \
                    and not isinstance(v, bool):
                v = float(v)
            if not isinstance(v, want) or isinstance(v, bool):
                raise JobError(f, f"must be {want.__name__}, got "
                                  f"{type(v).__name__}")
            kw[f] = v
        fv = doc.get("f_values")
        if kind == "sweep":
            if not isinstance(fv, list) or not fv or not all(
                    isinstance(x, int) and not isinstance(x, bool)
                    for x in fv):
                raise JobError("f_values", "sweep jobs need a non-empty "
                                           "list of integer fault counts")
            if len(fv) > limits["f_values"]:
                raise JobError("f_values",
                               f"at most {limits['f_values']} points "
                               f"per sweep job")
            kw["f_values"] = tuple(int(x) for x in fv)
        elif fv is not None:
            raise JobError("f_values", f"only sweep jobs take an f grid "
                                       f"(kind={kind!r})")
        for f in ("n_nodes", "trials", "max_rounds"):
            v = kw.get(f, getattr(defaults, f))
            if v < 1:
                raise JobError(f, "must be >= 1")
            if v > limits[f]:
                raise JobError(f, f"demo-scale request plane caps {f} at "
                                  f"{limits[f]} (see README Serving)")
        if kw.get("committee_cap", 0) > limits["committee_cap"]:
            raise JobError(
                "committee_cap",
                f"demo-scale request plane caps committee_cap at "
                f"{limits['committee_cap']} (it sizes the per-committee "
                f"histogram; see README Serving)")
        if kw.get("seed", 0) < 0:
            # run_point's input stream (np.random.default_rng) rejects
            # negative seeds — surface it at validation, not in a batch
            raise JobError("seed", "must be >= 0")
        spec = cls(**kw)
        spec.to_config()        # surface SimConfig's own rejections as 400s
        return spec

    @classmethod
    def from_config(cls, cfg: SimConfig,
                    kind: str = "simulate") -> "JobSpec":
        """The serve-plane job document that replays ``cfg`` through the
        request plane with run_point's default inputs — the provenance
        hook results.py attaches to its study rows (``serve_replay``).
        Only the wire-representable fields travel (CONFIG_FIELDS);
        observability flags are the KIND's business (trajectory/audit),
        so a record/witness-armed config maps to the matching kind."""
        if cfg.witness:
            kind = "audit"
        elif cfg.record:
            kind = "trajectory"
        return cls(kind=kind,
                   **{f: getattr(cfg, f) for f in CONFIG_FIELDS})

    def to_dict(self) -> Dict[str, Any]:
        d = {f: getattr(self, f) for f in CONFIG_FIELDS}
        d["kind"] = self.kind
        if self.f_values is not None:
            d["f_values"] = list(self.f_values)
        return d

    def to_config(self) -> SimConfig:
        """The SimConfig this job runs — observability flags derived from
        the kind (trajectory arms the flight recorder, audit the witness
        plane), everything else forwarded verbatim.  SimConfig's own
        validation errors re-raise as structured JobErrors."""
        kw = {f: getattr(self, f) for f in CONFIG_FIELDS}
        if self.kind == "trajectory":
            kw["record"] = True
        elif self.kind == "audit":
            from ..audit import default_witness_overrides
            kw.update(default_witness_overrides(self.trials, self.n_nodes))
        try:
            return SimConfig(**kw)
        except ValueError as e:
            raise JobError("config", str(e)) from e

    def expand(self) -> List["JobSpec"]:
        """The batch-slot decomposition: a sweep job becomes one
        simulate job per f value (each point coalesces independently);
        every other kind is already one slot."""
        if self.kind != "sweep":
            return [self]
        return [dataclasses.replace(self, kind="simulate",
                                    n_faulty=int(f), f_values=None)
                for f in self.f_values]


def job_inputs(cfg: SimConfig, device=None):
    """(initial_values, faults) for one job on ``device``: run_point's
    defaults exactly (per-trial random bits from the job seed, the first F
    lanes crash-faulty), so a served job equals run_point by construction."""
    from ..sweep import default_crash_faults, random_inputs
    return (random_inputs(cfg.seed, cfg.trials, cfg.n_nodes),
            default_crash_faults(cfg, device))


def result_dict(point, spec: JobSpec) -> Dict[str, Any]:
    """A SweepPoint -> the JSON result payload a client receives.  The
    big per-round arrays are NOT embedded (trajectory/audit stream them
    as SSE rows); the summary matches SweepPoint.to_dict's fields."""
    out = {
        "kind": spec.kind,
        "n_nodes": point.n_nodes, "n_faulty": point.n_faulty,
        "trials": point.trials, "coin_mode": point.coin_mode,
        "scheduler": point.scheduler,
        "rounds_executed": point.rounds_executed,
        "decided_frac": point.decided_frac, "mean_k": point.mean_k,
        "ones_frac": point.ones_frac,
        "disagree_frac": point.disagree_frac,
        "k_hist": point.k_hist.tolist(),
        "seconds": point.seconds,
    }
    return out
