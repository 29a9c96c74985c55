"""Protocol invariant auditor: machine-checked Ben-Or forensics (port of
benor_tpu/audit.py).

A witness buffer (``SimConfig(witness_trials=..., witness_nodes=k)``,
filled by every loop of the port, state.WIT_* columns) is replayed on the
host and checked against the Ben-Or invariants of the reference
(``src/nodes/node.ts``), each breach reported with its minimal witness
(trial, round, node ids, tallies):

  agreement        no two honest nodes of a trial decide different values
                   (the decide rule is ``count(v) > F`` with the 0-branch
                   first, node.ts:99-104);
  validity         under unanimous inputs v every decision is v (armed
                   when the watched inputs are known unanimous: full node
                   coverage, or the caller asserts it);
  irrevocability   a decided lane never revokes nor changes its value
                   (node.ts:100,103,147-157);
  quorum_evidence  every decide is backed by a ``> F`` tally of its value
                   with the 0-branch first, "?" is never decided, a coin
                   commit (node.ts:111) has the complementary evidence;
                   under an adjacency topology every tally fits the d + 1
                   neighbourhood (``tally_bound``), during a partition's
                   epoch the watched node's group;
  killed_silence   a killed lane's (x, decided) freeze and it never
                   commits another coin (node.ts:21-26,191-194);
  down_silence     a crash_recover lane does nothing inside its down
                   interval [crash_round, recover_round).

Host-side numpy: the auditor reads a buffer copied off the device and
never launches anything.  The bundle JSON (``save_bundle`` /
``load_bundle``) is the JAX package's document, so a bundle saved by one
package loads and audits in the other.  Every audit ticks the JAX
auditor's ``audit.*`` counters of the metrics registry (runs, pass / fail,
violations, one counter an invariant broken).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from .config import WITNESS_MAX_NODES, SimConfig, VAL0, VAL1, VALQ
from .state import (WIT_COINED, WIT_COLUMNS, WIT_DECIDED, WIT_KILLED,
                    WIT_P0, WIT_P1, WIT_V0, WIT_V1, WIT_WIDTH, WIT_WRITTEN,
                    WIT_X, FaultSpec, witness_node_ids)

#: The audited invariants, in check order: the reports' and the bundle
#: schema's names.  ``down_silence``: a crash_recover lane inside its
#: down interval [crash_round, recover_round) does nothing (no decide, no
#: coin commit, no state change) until it rejoins; irrevocability keeps
#: holding across the recovery, amnesia or not (decisions are durable).
INVARIANTS = ("agreement", "validity", "irrevocability",
              "quorum_evidence", "killed_silence", "down_silence")


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.asarray(a)


# --------------------------------------------------------------------------
# Bundle: a witness buffer plus the static facts the checks need.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WitnessBundle:
    """One run's witness evidence, self-describing for offline audit.

    ``buffer`` is the loop-filled int32 [max_rounds + 1, W, k,
    WIT_WIDTH] array; ``trial_ids``/``node_ids`` name the watched GLOBAL
    ids; ``faulty`` (optional bool [W, k]) marks watched lanes that are
    protocol-faulty (equivocators / byzantine senders — their own
    decisions are excluded from the agreement/validity checks);
    ``unanimous`` (0, 1 or None) asserts that ALL inputs — watched or not
    — were that value, arming the validity check even under partial node
    coverage.
    """

    buffer: np.ndarray
    trial_ids: np.ndarray          # int [W] global trial ids
    node_ids: np.ndarray           # int [k] global node ids
    rule: str                      # 'reference' | 'textbook'
    n_faulty: int                  # F — the decide bar count > F
    n_nodes: int
    freeze_decided: bool = True
    faulty: Optional[np.ndarray] = None     # bool [W, k] or None
    unanimous: Optional[int] = None         # 0 | 1 | None
    #: Structural ceiling on any witnessed tally — the RELAXED quorum-
    #: evidence bound of the topo delivery plane: under
    #: an adjacency topology a receiver tallies at most its d + 1
    #: neighborhood, so any p0+p1 / v0+v1 beyond that is forged
    #: evidence the complete-graph checks could never see.  None (every
    #: pre-topology bundle) disables the bound — the global quorum
    #: bound stays implied by the decide-bar checks, exactly as before.
    tally_bound: Optional[int] = None
    #: Faultlab evidence.  ``partition``: the run's partition
    #: spec string (faults/partitions.py grammar) — during the epoch
    #: (1 <= round < heal_round) every witnessed tally is additionally
    #: bounded by the watched node's GROUP size (quorum evidence judged
    #: within the partition epoch); None = no partition, no bound.
    #: ``down_crash`` / ``down_recover`` (int [W, k] or None): the
    #: watched lanes' crash_recover down-interval bounds, arming the
    #: down_silence check; None = no churn schedule.
    partition: Optional[str] = None
    down_crash: Optional[np.ndarray] = None
    down_recover: Optional[np.ndarray] = None
    label: str = ""

    @classmethod
    def from_run(cls, cfg: SimConfig, buffer, faults=None,
                 unanimous: Optional[int] = None,
                 label: str = "") -> "WitnessBundle":
        """Bundle a run's witness output with the facts its config and
        (optionally) FaultSpec pin down.  ``faults`` narrows the honest
        population — but only under the lying fault models
        ('byzantine'/'equivocate'): a fail-stop lane ('crash',
        'crash_at_round') follows the protocol until it dies, so its
        decisions MUST count for agreement/validity.  ``unanimous``
        asserts globally-unanimous inputs.  Under an adjacency topology
        (cfg.topology) the bundle carries the d + 1 neighborhood as its
        ``tally_bound`` — the relaxed quorum-evidence ceiling the
        auditor enforces instead of the (unrepresentable) global
        quorum."""
        if not cfg.witness:
            raise ValueError("cfg has no witness armed (witness_trials)")
        trial_ids = np.asarray(cfg.witness_trials, np.int64)
        node_ids = np.asarray(witness_node_ids(cfg), np.int64)
        faulty = None
        if faults is not None and cfg.fault_model in ("byzantine",
                                                      "equivocate"):
            faulty = _host(faults.faulty)[np.ix_(trial_ids, node_ids)]
        bound = None
        if cfg.topology is not None:
            from .topo.graphs import parse_topology
            bound = parse_topology(cfg.topology).degree + 1
        down_crash = down_recover = None
        if cfg.fault_model == "crash_recover" and faults is not None \
                and faults.recover_round is not None:
            sel = np.ix_(trial_ids, node_ids)
            down_crash = _host(faults.crash_round)[sel]
            down_recover = _host(faults.recover_round)[sel]
        return cls(buffer=_host(buffer), trial_ids=trial_ids,
                   node_ids=node_ids, rule=cfg.rule,
                   n_faulty=cfg.n_faulty, n_nodes=cfg.n_nodes,
                   freeze_decided=cfg.freeze_decided, faulty=faulty,
                   unanimous=unanimous, tally_bound=bound,
                   partition=cfg.partition, down_crash=down_crash,
                   down_recover=down_recover, label=label)

    def to_dict(self) -> Dict:
        return {
            "label": self.label,
            "rule": self.rule,
            "n_faulty": int(self.n_faulty),
            "n_nodes": int(self.n_nodes),
            "freeze_decided": bool(self.freeze_decided),
            "trial_ids": [int(t) for t in self.trial_ids],
            "node_ids": [int(n) for n in self.node_ids],
            "unanimous": (None if self.unanimous is None
                          else int(self.unanimous)),
            "tally_bound": (None if self.tally_bound is None
                            else int(self.tally_bound)),
            "partition": self.partition,
            "down_crash": (None if self.down_crash is None
                           else np.asarray(self.down_crash)
                           .astype(int).tolist()),
            "down_recover": (None if self.down_recover is None
                             else np.asarray(self.down_recover)
                             .astype(int).tolist()),
            "faulty": (None if self.faulty is None
                       else np.asarray(self.faulty).astype(bool).tolist()),
            "columns": list(WIT_COLUMNS),
            "buffer": np.asarray(self.buffer).astype(int).tolist(),
        }


def witness_rows(buffer, trial_ids, node_ids) -> List[dict]:
    """Witness buffer int32 [rounds, W, k, WIT_WIDTH] -> one dict per
    written (round, trial, node) entry, WIT_COLUMNS-keyed (the sentinel
    left out) plus the global "round", "trial" and "node" ids.  Unwritten
    rows (a fresh-buffer resume's gap among them) are skipped by the
    sentinel."""
    buf = _host(buffer).astype(np.int64)
    rows = []
    for r in np.nonzero(buf[:, 0, 0, WIT_WRITTEN] > 0)[0]:
        for wi, t in enumerate(trial_ids):
            for ki, n in enumerate(node_ids):
                d = {"round": int(r), "trial": int(t), "node": int(n)}
                d.update({col: int(v) for col, v
                          in zip(WIT_COLUMNS[:WIT_WRITTEN],
                                 buf[r, wi, ki])})
                rows.append(d)
    return rows


# --------------------------------------------------------------------------
# Reports
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Violation:
    """One invariant breach with its minimal witness."""

    invariant: str                 # one of INVARIANTS
    trial: int                     # global trial id
    round: int                     # round index of the (last) breach
    nodes: List[int]               # global node ids involved
    detail: Dict                   # tallies / values justifying the claim
    message: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AuditReport:
    """The auditor's verdict over one witness bundle."""

    ok: bool
    violations: List[Violation]
    checks: Dict[str, int]         # per-invariant count of checks applied
    rounds_audited: int
    lanes_audited: int
    label: str = ""

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "label": self.label,
            "rounds_audited": self.rounds_audited,
            "lanes_audited": self.lanes_audited,
            "checks": dict(self.checks),
            "n_violations": len(self.violations),
            "violations": [v.to_dict() for v in self.violations],
        }

    def summary(self) -> str:
        if self.ok:
            return (f"audit OK: {self.lanes_audited} lanes x "
                    f"{self.rounds_audited} rounds, "
                    f"{sum(self.checks.values())} checks, 0 violations")
        v = self.violations[0]
        return (f"audit FAILED: {len(self.violations)} violation(s); "
                f"first: {v.message}")


# --------------------------------------------------------------------------
# The auditor
# --------------------------------------------------------------------------


def _first_decide(series):
    """(decide_round_index_into_series or None, pre_decided: bool)."""
    dec = series[:, WIT_DECIDED] > 0
    if not dec.any():
        return None, False
    first = int(np.argmax(dec))
    return first, first == 0      # decided in row 0 => decide unobserved


def _decide_claim(node, value, rd, v0, v1, F):
    """One node's decide, phrased with only the facts the witness saw:
    a snapshot-decided lane (fresh-buffer resume) has no observed tallies
    — never assert quorum evidence the buffer doesn't contain."""
    tally = v0 if value == VAL0 else v1
    if tally is None:
        return (f"node {node} decided {value} at round {rd} "
                f"(decide pre-dates the witness window)")
    return (f"node {node} decided {value} at round {rd} "
            f"(v{value}={tally} > F={F})")


def audit_witness(bundle: WitnessBundle) -> AuditReport:
    """Machine-check the Ben-Or invariants over a witness bundle.

    Returns an AuditReport whose violations carry minimal witnesses
    (trial, round, node ids, tallies), in the JAX auditor's order.
    """
    buf = _host(bundle.buffer).astype(np.int64)
    if buf.ndim != 4 or buf.shape[-1] != WIT_WIDTH:
        raise ValueError(
            f"witness buffer must be [rounds, W, k, {WIT_WIDTH}]; got "
            f"{buf.shape}")
    W, k = buf.shape[1], buf.shape[2]
    F = int(bundle.n_faulty)
    violations: List[Violation] = []
    checks = {name: 0 for name in INVARIANTS}
    written = np.nonzero(buf[:, 0, 0, WIT_WRITTEN] > 0)[0]
    part_spec = None
    if bundle.partition is not None:
        from .faults.partitions import parse_partition
        part_spec = parse_partition(bundle.partition)

    # validity ground truth: caller-asserted, or derivable when the
    # witness covers EVERY node (k == n_nodes) and row 0 is unanimous —
    # partial coverage must not let a locally-unanimous watched set
    # masquerade as global unanimity (an honest global-minority decide
    # would then be flagged as a violation that never happened)
    full_cover = k == bundle.n_nodes and 0 in written

    for wi in range(W):
        trial = int(bundle.trial_ids[wi])
        honest = np.ones(k, bool)
        if bundle.faulty is not None:
            honest = ~np.asarray(bundle.faulty[wi], bool)

        unanimous = bundle.unanimous
        if unanimous is None and full_cover:
            x0 = buf[0, wi, :, WIT_X]
            live0 = buf[0, wi, :, WIT_KILLED] == 0
            vals = np.unique(x0[honest & live0])
            if len(vals) == 1 and vals[0] in (VAL0, VAL1):
                unanimous = int(vals[0])

        decided_evidence = []      # (node_id, value, round, v0, v1) honest
        for ki in range(k):
            node = int(bundle.node_ids[ki])
            rounds, series = written, buf[written, wi, ki, :]
            x = series[:, WIT_X]
            dec = series[:, WIT_DECIDED] > 0
            killed = series[:, WIT_KILLED] > 0
            coined = series[:, WIT_COINED] > 0
            v0, v1 = series[:, WIT_V0], series[:, WIT_V1]

            first, pre_decided = _first_decide(series)

            # --- neighborhood tally bound (topo delivery plane) ---------
            # Under an adjacency topology the quorum rule is
            # NEIGHBORHOOD-relative: a receiver tallies at most its
            # d + 1 neighborhood, so any witnessed phase tally beyond
            # bundle.tally_bound is forged evidence (the relaxed
            # invariant of the topology plane).
            # Filed under quorum_evidence: it is the structural half of
            # the same "was this decide backed by real counts" claim.
            if bundle.tally_bound is not None:
                checks["quorum_evidence"] += 1
                p0, p1 = series[:, WIT_P0], series[:, WIT_P1]
                over = np.nonzero((p0 + p1 > bundle.tally_bound) |
                                  (v0 + v1 > bundle.tally_bound))[0]
                for oi in over:
                    rd = int(rounds[oi])
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node],
                        {"round": rd, "p0": int(p0[oi]), "p1": int(p1[oi]),
                         "v0": int(v0[oi]), "v1": int(v1[oi]),
                         "tally_bound": int(bundle.tally_bound)},
                        f"trial {trial} node {node} tallied more "
                        f"messages than its d+1={int(bundle.tally_bound)}"
                        f" neighborhood can deliver at round {rd} "
                        f"(p0+p1={int(p0[oi] + p1[oi])}, "
                        f"v0+v1={int(v0[oi] + v1[oi])}) — forged "
                        "evidence under the topology-relative quorum"))

            # --- partition-epoch tally bound (faultlab) ----------------
            # During the epoch (1 <= round < heal_round) a receiver can
            # tally at most its GROUP: any witnessed phase tally beyond
            # the group size is forged cross-partition quorum evidence.
            # Filed under quorum_evidence like the neighborhood bound —
            # the structural half of the same claim.  Row 0 is the
            # pre-round snapshot (no tallies) and rounds >= heal_round
            # see the whole network again.
            if part_spec is not None:
                from .faults.partitions import group_size_of
                checks["quorum_evidence"] += 1
                gsize = group_size_of(node, bundle.n_nodes, part_spec)
                p0, p1 = series[:, WIT_P0], series[:, WIT_P1]
                epoch = (rounds >= 1) & (rounds < part_spec.heal_round)
                over = np.nonzero(epoch & ((p0 + p1 > gsize) |
                                           (v0 + v1 > gsize)))[0]
                for oi in over:
                    rd = int(rounds[oi])
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node],
                        {"round": rd, "p0": int(p0[oi]), "p1": int(p1[oi]),
                         "v0": int(v0[oi]), "v1": int(v1[oi]),
                         "group_size": int(gsize),
                         "heal_round": int(part_spec.heal_round)},
                        f"trial {trial} node {node} tallied more "
                        f"messages than its partition group of "
                        f"{int(gsize)} can deliver at round {rd} "
                        f"(p0+p1={int(p0[oi] + p1[oi])}, "
                        f"v0+v1={int(v0[oi] + v1[oi])}; epoch heals at "
                        f"round {int(part_spec.heal_round)}) — forged "
                        "cross-partition quorum evidence"))

            # --- down-interval silence (faultlab) ----------------------
            # A crash_recover lane inside [crash_round, recover_round)
            # participates in NOTHING: no coin commit, no decide flip,
            # no state change — its witnessed rows must equal the last
            # pre-crash row until the rejoin.
            if bundle.down_crash is not None:
                cr_b = int(bundle.down_crash[wi, ki])
                rv_b = int(bundle.down_recover[wi, ki])
                if cr_b > 0:
                    checks["down_silence"] += 1
                    interval = rounds >= cr_b
                    if rv_b > 0:
                        interval = interval & (rounds < rv_b)
                    before = np.nonzero(rounds < cr_b)[0]
                    idx = np.nonzero(interval)[0]
                    if before.size and idx.size:
                        b0 = int(before[-1])
                        bad = ((coined[idx]) |
                               (dec[idx] != dec[b0]) |
                               (x[idx] != x[b0]))
                        for oi in np.nonzero(bad)[0]:
                            rd = int(rounds[idx[oi]])
                            violations.append(Violation(
                                "down_silence", trial, rd, [node],
                                {"round": rd, "crash_round": cr_b,
                                 "recover_round": rv_b,
                                 "x_before": int(x[b0]),
                                 "x": int(x[idx[oi]]),
                                 "decided_before": bool(dec[b0]),
                                 "decided": bool(dec[idx[oi]]),
                                 "coined": bool(coined[idx[oi]])},
                                f"trial {trial} node {node} "
                                f"participated at round {rd} inside "
                                f"its down interval "
                                f"[{cr_b}, {rv_b if rv_b > 0 else '∞'})"
                                " — a down lane must be silent"))

            # --- irrevocability (node.ts:100,103,147-157) ---------------
            checks["irrevocability"] += 1
            if first is not None:
                tail = slice(first, None)
                if not dec[tail].all():
                    rbad = int(rounds[first:][~dec[tail]][0])
                    violations.append(Violation(
                        "irrevocability", trial, rbad, [node],
                        {"decide_round": int(rounds[first])},
                        f"trial {trial} node {node} revoked decided at "
                        f"round {rbad} (decided at {int(rounds[first])})"))
                elif bundle.freeze_decided and \
                        (x[tail] != x[first]).any():
                    bad_i = first + int(np.argmax(x[tail] != x[first]))
                    rbad = int(rounds[bad_i])
                    violations.append(Violation(
                        "irrevocability", trial, rbad, [node],
                        {"decided_value": int(x[first]),
                         "changed_to": int(x[bad_i])},
                        f"trial {trial} node {node} changed its decided "
                        f"value after deciding (round {rbad})"))

            # --- quorum evidence (node.ts:99-104; coin node.ts:111) -----
            if first is not None and not pre_decided:
                checks["quorum_evidence"] += 1
                rd = int(rounds[first])
                val = int(x[first])
                ev = {"round": rd, "v0": int(v0[first]),
                      "v1": int(v1[first]), "F": F}
                if val == VALQ:
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node], ev,
                        f"trial {trial} node {node} decided \"?\" at "
                        f"round {rd} — no decide branch produces it"))
                elif val == VAL0 and not v0[first] > F:
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node], ev,
                        f"trial {trial} node {node} decided 0 at round "
                        f"{rd} on v0={int(v0[first])} <= F={F}"))
                elif val == VAL1 and not v1[first] > F:
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node], ev,
                        f"trial {trial} node {node} decided 1 at round "
                        f"{rd} on v1={int(v1[first])} <= F={F}"))
                elif val == VAL1 and v0[first] > F:
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node], ev,
                        f"trial {trial} node {node} decided 1 at round "
                        f"{rd} although v0={int(v0[first])} > F={F} — "
                        "the 0-branch is checked first (node.ts:99)"))
            # coin commits carry complementary evidence
            for ci in np.nonzero(coined)[0]:
                checks["quorum_evidence"] += 1
                rd, ev = int(rounds[ci]), {
                    "round": int(rounds[ci]), "v0": int(v0[ci]),
                    "v1": int(v1[ci]), "F": F}
                # a decided lane only stops coining when it freezes; with
                # freeze_decided=False it legally re-coins on later ties
                bad = ((bundle.freeze_decided and dec[ci]) or
                       (bundle.rule == "reference" and v0[ci] != v1[ci]) or
                       (bundle.rule == "textbook" and
                        (v0[ci] > F or v1[ci] > F)))
                if bad:
                    violations.append(Violation(
                        "quorum_evidence", trial, rd, [node], ev,
                        f"trial {trial} node {node} committed a coin at "
                        f"round {rd} despite decide/adopt evidence "
                        f"(v0={int(v0[ci])}, v1={int(v1[ci])})"))

            # --- killed silence (node.ts:21-26,191-194) -----------------
            checks["killed_silence"] += 1
            if killed.any():
                kf = int(np.argmax(killed))
                tail = slice(kf, None)
                if (x[tail] != x[kf]).any() or \
                        (series[tail, WIT_DECIDED] !=
                         series[kf, WIT_DECIDED]).any() or \
                        coined[tail].any():
                    rbad = int(rounds[kf])
                    violations.append(Violation(
                        "killed_silence", trial, rbad, [node],
                        {"killed_round": int(rounds[kf])},
                        f"trial {trial} node {node} kept participating "
                        f"after being killed at round {int(rounds[kf])}"))

            # collect the decide evidence for the trial-level checks; a
            # snapshot decide (pre_decided: fresh-buffer resume) is a real
            # decision but its justifying tallies were never witnessed
            if honest[ki] and first is not None and \
                    int(x[first]) in (VAL0, VAL1):
                decided_evidence.append(
                    (node, int(x[first]), int(rounds[first]),
                     None if pre_decided else int(v0[first]),
                     None if pre_decided else int(v1[first])))

        # --- agreement (node.ts:99-104) ---------------------------------
        checks["agreement"] += 1
        by_value: Dict[int, tuple] = {}
        for evd in decided_evidence:
            by_value.setdefault(evd[1], evd)
        if VAL0 in by_value and VAL1 in by_value:
            a, b = by_value[VAL0], by_value[VAL1]
            violations.append(Violation(
                "agreement", trial, max(a[2], b[2]), [a[0], b[0]],
                {"node_a": {"node": a[0], "value": 0, "round": a[2],
                            "v0": a[3], "v1": a[4]},
                 "node_b": {"node": b[0], "value": 1, "round": b[2],
                            "v0": b[3], "v1": b[4]},
                 "F": F},
                f"trial {trial}: "
                f"{_decide_claim(a[0], 0, a[2], a[3], a[4], F)} but "
                f"{_decide_claim(b[0], 1, b[2], b[3], b[4], F)}"
                " — agreement violated"))

        # --- validity ----------------------------------------------------
        if unanimous is not None:
            checks["validity"] += 1
            for node, val, rd, e0, e1 in decided_evidence:
                if val != unanimous:
                    violations.append(Violation(
                        "validity", trial, rd, [node],
                        {"unanimous_input": int(unanimous),
                         "decided": val, "v0": e0, "v1": e1, "F": F},
                        f"trial {trial} node {node} decided {val} at "
                        f"round {rd} despite unanimous input "
                        f"{int(unanimous)}"))

    report = AuditReport(
        ok=not violations, violations=violations, checks=checks,
        rounds_audited=max(len(written) - 1, 0), lanes_audited=W * k,
        label=bundle.label)

    from .utils.metrics import REGISTRY
    REGISTRY.counter("audit.runs").inc()
    REGISTRY.counter("audit.pass" if report.ok else "audit.fail").inc()
    REGISTRY.counter("audit.violations").inc(len(violations))
    for v in violations:
        REGISTRY.counter(f"audit.violation.{v.invariant}").inc()
    return report


# --------------------------------------------------------------------------
# Convenience: run-and-audit, bundle persistence
# --------------------------------------------------------------------------


def default_witness_overrides(trials: int, n_nodes: int) -> Dict:
    """The default forensic watch-set, as SimConfig overrides: the first
    min(trials, 4) trials and as many nodes as the buffer allows
    (witness_node_ids puts them at both ends of the id range, where the
    adversary camps and fault masks live).  The one policy the CLI
    ``audit`` defaults and results.py's safety reruns share."""
    return {"witness_trials": tuple(range(min(trials, 4))),
            "witness_nodes": min(n_nodes, WITNESS_MAX_NODES)}


def audit_point(cfg: SimConfig, initial_values=None,
                faults: Optional[FaultSpec] = None,
                unanimous: Optional[int] = None, label: str = "",
                device=None):
    """Run one witnessed MC batch and audit it -> (report, bundle).

    ``cfg`` must have the witness armed; inputs/faults default like
    sweep.run_point (per-trial random bits, first-F-faulty).  The bundle
    carries the watched lanes' faulty mask, so equivocators'/byzantine
    senders' own decisions stay out of the agreement check.  Runs on CUDA
    unless ``device`` names the CPU.
    """
    from .sim import resolve_device, run_consensus
    from .state import init_state
    from .sweep import default_crash_faults, random_inputs

    if not cfg.witness:
        raise ValueError(
            "audit_point needs a witnessed config: set "
            "SimConfig(witness_trials=..., witness_nodes=k)")
    if initial_values is None:
        initial_values = random_inputs(cfg.seed, cfg.trials, cfg.n_nodes)
    dev = resolve_device(device)
    if faults is None:
        # run_point's exact default policy (first-F-faulty; crash_recover
        # realizes the cfg.recovery schedule) so an audited point IS the
        # swept point
        faults = default_crash_faults(cfg, dev)
    else:
        faults = faults.to(dev)
    state = init_state(cfg, initial_values, faults)
    witness = run_consensus(cfg, state, faults)[-1]
    bundle = WitnessBundle.from_run(cfg, witness, faults=faults,
                                    unanimous=unanimous, label=label)
    return audit_witness(bundle), bundle


def save_bundle(path: str, bundle: WitnessBundle,
                report: Optional[AuditReport] = None) -> None:
    """Dump a witness bundle (+ its audit verdict) as one JSON document,
    the artifact results.py's safety studies attach to violating points
    (the JAX package's schema, tools/witness_bundle_schema.json)."""
    doc = bundle.to_dict()
    if report is not None:
        doc["audit"] = report.to_dict()
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)


def load_bundle(path: str) -> WitnessBundle:
    """Re-hydrate a saved bundle for offline (re-)auditing."""
    with open(path) as fh:
        doc = json.load(fh)
    return WitnessBundle(
        buffer=np.asarray(doc["buffer"], np.int64),
        trial_ids=np.asarray(doc["trial_ids"], np.int64),
        node_ids=np.asarray(doc["node_ids"], np.int64),
        rule=doc["rule"], n_faulty=doc["n_faulty"],
        n_nodes=doc["n_nodes"],
        freeze_decided=doc.get("freeze_decided", True),
        faulty=(None if doc.get("faulty") is None
                else np.asarray(doc["faulty"], bool)),
        unanimous=doc.get("unanimous"),
        tally_bound=doc.get("tally_bound"),
        partition=doc.get("partition"),
        down_crash=(None if doc.get("down_crash") is None
                    else np.asarray(doc["down_crash"], np.int64)),
        down_recover=(None if doc.get("down_recover") is None
                      else np.asarray(doc["down_recover"], np.int64)),
        label=doc.get("label", ""))
