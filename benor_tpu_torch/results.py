"""The science deliverables: the studies behind RESULTS/ (port of
benor_tpu/results.py).

``generate`` runs the BASELINE.json presets and the N = 1M studies and
writes RESULTS/results.json and RESULTS.md, the JAX package's documents.
The studies:

  balanced_curve   — expected rounds vs fault fraction, balanced inputs,
                     zero crashes (F purely a protocol parameter).
  margin_sweep     — outcomes vs the initial margin delta (1-count =
                     N/2 + delta*sqrt(N)/2) at f = 0.4.
  coin_contrast    — private vs shared common coin under the
                     count-controlling adversary.
  disagreement     — agreement-safety violation rate vs the split
                     adversary's strength s.
  safety_violation — agreement under the TARGETED adversary: a 0/1 curve,
                     violated at every 1 <= F < N/2 (even quorum),
                     livelock past 1/2, and one equivocator kills
                     agreement at any N.  Both safety studies rerun every
                     violating point with the witness armed
                     (``_witness_rerun``), attach the auditor's verdict
                     (audit.py) and a replayable ``atlas_repro``.
  equivocation     — the N > 3F bound located to +-1 node of N/3.
  trajectory, scaling, rule_comparison, weak_coin — round-resolved
                     dynamics, rounds and throughput vs N, the reference
                     decide rule vs textbook Ben-Or, termination vs the
                     weak coin's deviation rate.
  topo_curves, faults_curves — the structured-delivery and faultlab rows.

  oracle_parity    — the native event-loop oracle's rounds-to-decide law
                     against the simulator's (N = 100); ``generate`` skips
                     it where there is no C++ compiler, as the JAX
                     package does.

Every entry runs on CUDA unless ``device`` names the CPU.  On the card
``_flagship_flags`` arms the round kernels and fused samplers for the
studies that take them; on the CPU it arms nothing, as the JAX package
does on its CPU.  Nothing probes a kernel or falls back: a kernel that
fails to build or launch raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np

from .config import SimConfig
from .sim import device_identity, resolve_device, run_consensus
from .state import FaultSpec, init_state
from .sweep import (SweepPoint, baseline_configs, coin_comparison,
                    record_trajectory, run_point)

#: Default fault fractions for the balanced rounds-vs-f curve.
CURVE_FRACS = (0.10, 0.25, 0.35, 0.40, 0.45)
#: Margin multipliers (x sqrt(N)) for the margin sweep.  The interesting
#: window is delta < ~0.5: the value bias (ones_frac) saturates by
#: delta ~ 0.1 while the round count only drops once the margin survives
#: BOTH amplification phases of round 1 (delta ~ 0.4) — two distinct
#: transitions, both inside sampling noise scale.
MARGINS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0)


def _balanced(trials: int, n: int, extra_ones: int = 0) -> np.ndarray:
    """Inputs with exactly floor(N/2) + extra_ones ones per trial."""
    ones = n // 2 + extra_ones
    row = np.zeros(n, np.int8)
    row[:ones] = 1
    return np.tile(row, (trials, 1))


#: The fused flagship path's flag set: one definition, shared by the
#: studies below and the CLI's ``--pallas on``.
FLAGSHIP_FLAGS = {"use_pallas_hist": True, "use_pallas_round": True}


def _flagship_flags(device=None) -> Dict[str, bool]:
    """The flagship path's flags for the accelerator-scale studies:
    ``FLAGSHIP_FLAGS`` when the studies run on the card, where the round
    kernels and the fused samplers serve them, and none on the CPU, as the
    JAX package arms none on its CPU.  Configs the kernels do not serve
    (non-uniform schedulers, quorums within ``EXACT_TABLE_MAX``) ignore
    them (ops/tally.py:pallas_round_active).  Nothing demotes a study: a
    kernel that fails to build or launch raises."""
    if resolve_device(device).type == "cpu":
        return {}
    return dict(FLAGSHIP_FLAGS)


def balanced_curve(n: int, trials: int, seed: int = 0,
                   fracs=CURVE_FRACS, verbose=True,
                   device=None) -> List[SweepPoint]:
    pts = []
    for frac in fracs:
        cfg = SimConfig(n_nodes=n, n_faulty=int(frac * n), trials=trials,
                        max_rounds=64, delivery="quorum",
                        scheduler="uniform", path="histogram", seed=seed,
                        **_flagship_flags(device))
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=FaultSpec.none(trials, n), device=device)
        pts.append(pt)
        if verbose:
            print(f"  f={frac:.2f}: mean_k={pt.mean_k:.3f} "
                  f"decided={pt.decided_frac:.3f} ones={pt.ones_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    return pts


def margin_sweep(n: int, trials: int, seed: int = 0, f_frac: float = 0.40,
                 margins=MARGINS, verbose=True, device=None) -> List[Dict]:
    rows = []
    for delta in margins:
        extra = int(round(delta * np.sqrt(n) / 2))  # 1-count - N/2
        cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                        max_rounds=64, delivery="quorum",
                        scheduler="uniform", path="histogram", seed=seed,
                        **_flagship_flags(device))
        pt = run_point(cfg, initial_values=_balanced(trials, n, extra),
                       faults=FaultSpec.none(trials, n), device=device)
        rows.append({"delta": delta, "extra_ones": extra, **pt.to_dict()})
        if verbose:
            print(f"  delta={delta}: mean_k={pt.mean_k:.3f} "
                  f"ones={pt.ones_frac:.3f}", flush=True)
    return rows


def _witness_rerun(cfg: SimConfig, initial_values, faults, tag: str,
                   out_dir=None, verbose=True, device=None) -> Dict:
    """Forensic auto-rerun of an agreement-violating safety point.

    When a safety study reports ``disagree_frac > 0`` the aggregate says
    only THAT agreement broke; this reruns the same (config, seed) point
    with the witness recorder armed (first few trials, both ends of the
    node-id range — where the camps and fault masks live), machine-checks
    the Ben-Or invariants (audit.py) and dumps the witness
    bundle as JSON so the violation is pinpointed to (trial, round, node
    ids, tallies).  The rerun is bit-identical to the original point
    (witnessing never moves a random stream), so the evidence is OF the
    violating run, not of a lookalike.  Returns the summary dict the
    study row embeds.
    """
    from . import audit

    faults = faults.to(resolve_device(device))
    wcfg = cfg.replace(
        **audit.default_witness_overrides(cfg.trials, cfg.n_nodes))
    state = init_state(wcfg, initial_values, faults)
    out = run_consensus(wcfg, state, faults)
    bundle = audit.WitnessBundle.from_run(wcfg, out[-1], faults=faults,
                                          label=tag)
    report = audit.audit_witness(bundle)
    summary: Dict = {"audit_ok": report.ok,
                     "n_violations": len(report.violations)}
    if report.violations:
        summary["first_violation"] = report.violations[0].to_dict()
    if out_dir:
        path = os.path.join(out_dir, f"witness_{tag}.json")
        audit.save_bundle(path, bundle, report)
        summary["bundle"] = path
    if verbose:
        print(f"    {report.summary()}"
              + (f" -> {summary['bundle']}" if "bundle" in summary else ""),
              flush=True)
    return summary


def _violation_forensics(cfg, initial_values, faults, tag: str,
                         out_dir=None, verbose=True,
                         fault_policy: str = "none",
                         shrink: bool = False,
                         repro: bool = True, device=None) -> Dict:
    """The ONE forensic block every violating study row goes through:
    the witness-armed bit-identical rerun + audit (_witness_rerun), then
    a replayable ``kind: atlas_repro`` document (atlas/repro.py) whose
    digest and replay verdict ride in the row — every violation artifact
    is replayable via ``python -m benor_tpu_torch replay``, not just
    inspectable.  ``fault_policy`` is the repro's declarative fault knob
    ('none' for the adversary-only studies, 'default' for first-F-faulty
    rows).  ``shrink`` defaults OFF here: every shrink candidate is two
    more runs at the study's size — the shrinking minimal-repro search
    belongs to the atlas cliff path, where the configs are already
    small.  ``repro=False`` keeps the
    per-row witness rerun but skips the repro document (its build and
    replay are two more full runs): callers emit one repro per
    violation CLASS, not per row — later rows of the same class
    replay to the same-shaped document."""
    summary = _witness_rerun(cfg, initial_values, faults, tag,
                             out_dir=out_dir, verbose=verbose,
                             device=device)
    if not repro:
        return summary
    from .atlas import repro as arepro
    doc = arepro.build_repro(cfg, inputs="balanced",
                             faults=fault_policy, label=tag,
                             shrink=shrink, device=device)
    summary["repro_digest"] = doc["digest"]
    summary["repro_reproduced"] = bool(
        arepro.replay_repro(doc, device)["ok"])
    if out_dir:
        path = os.path.join(out_dir, f"repro_{tag}.json")
        arepro.save_repro(path, doc)
        summary["repro"] = path
        if verbose:
            print(f"    repro {doc['config']['trials']}x"
                  f"{doc['config']['n_nodes']} "
                  f"({doc['shrink_steps']} shrink steps, "
                  f"{'replays' if summary['repro_reproduced'] else 'STALE'}"
                  f") -> {path}", flush=True)
    return summary


#: Split-adversary strengths for the disagreement study — spaced to frame
#: the sharp safety phase transition (s_c ~ 0.45 at f = 0.25: below it the
#: quorum overlap still forces enough starved-class messages through to
#: keep both halves on the same majority; above it each parity class
#: decides its own favored value).  Stops at 1.0: on the histogram path
#: every s >= 1 is exact strict priority (biased_priority_counts ignores
#: the magnitude), so larger strengths are bit-identical repeats.
STRENGTHS = (0.0, 0.25, 0.4, 0.45, 0.5, 0.75, 1.0)


def disagreement_sweep(n: int, trials: int, seed: int = 0,
                       f_frac: float = 0.25, strengths=STRENGTHS,
                       verbose=True, out_dir=None,
                       device=None) -> List[Dict]:
    # the s=0 control is the same config as balanced_curve's f=0.25 point
    rows = []
    repro_done = False
    for s in strengths:
        cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                        max_rounds=64, delivery="quorum",
                        scheduler="biased" if s > 0 else "uniform",
                        adversary_strength=s, path="histogram", seed=seed,
                        **_flagship_flags(device))
        faults = FaultSpec.none(trials, n)
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=faults, device=device)
        row = {"strength": s, **pt.to_dict()}
        if verbose:
            print(f"  s={s}: disagree={pt.disagree_frac:.3f} "
                  f"decided={pt.decided_frac:.3f} mean_k={pt.mean_k:.2f}",
                  flush=True)
        if pt.disagree_frac > 0:
            # agreement broke: auto-rerun with witnessing to pin WHICH
            # nodes decided WHICH value on WHAT quorum evidence, and
            # emit the replayable minimal repro of the break
            row["witness_audit"] = _violation_forensics(
                cfg, _balanced(trials, n), faults,
                f"disagreement_s{s}", out_dir, verbose,
                repro=not repro_done, device=device)
            repro_done = True
        rows.append(row)
    return rows


#: Fault fractions for the targeted-adversary safety study, chosen to give
#: EVEN quorums at the default N (the attack's "?"-manufacturing step needs
#: perfect phase-1 ties) and to frame both boundaries: the f -> 0 edge and
#: the f = 1/2 flip to livelock.
def _even_quorum_f(n: int, frac: float) -> int:
    f = int(frac * n)
    return f + (n - f) % 2


def safety_violation(n: int, trials: int, seed: int = 0,
                     verbose=True, out_dir=None,
                     device=None) -> List[Dict]:
    """Agreement violation under the PARTITIONED count-controlling
    adversary (scheduler='targeted').

    Where the 'disagreement' study's delay-bounded split adversary yields a
    soft probabilistic curve with a transition near s_c ~ 0.45, this
    adversary's curve is exactly 0/1: disagree = 1.0 for EVERY
    1 <= F < N/2 (even quorum) and 0.0 outside — at f = 0 the full quorum
    leaves no slack, at f >= 1/2 the decide bar count > F is unreachable
    and the run livelocks.  The final rows put one equivocator in the
    population: agreement dies at ANY N (the count > F rule has no
    Byzantine safety margin at all).

    Every violating row auto-reruns with the witness recorder armed
    (_witness_rerun) and embeds the audit verdict — the minimal (trial,
    round, node, tallies) witness of its agreement break; bundles land in
    ``out_dir`` when given.
    """
    rows = []
    repro_classes = set()

    def _row(cfg, faults, extra, tag, fault_policy="none"):
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=faults, device=device)
        row = {**extra, **pt.to_dict()}
        if pt.disagree_frac > 0:
            row["witness_audit"] = _violation_forensics(
                cfg, _balanced(trials, n), faults, tag, out_dir,
                verbose, fault_policy=fault_policy,
                repro=fault_policy not in repro_classes, device=device)
            repro_classes.add(fault_policy)
        rows.append(row)
        return pt

    for frac in (0.0, 0.01, 0.1, 0.25, 0.4, 0.49):
        f = _even_quorum_f(n, frac) if frac else 0
        cfg = SimConfig(n_nodes=n, n_faulty=f, trials=trials, max_rounds=16,
                        delivery="quorum", scheduler="targeted",
                        path="histogram", seed=seed)
        pt = _row(cfg, FaultSpec.none(trials, n),
                  {"f": f, "f_frac": round(f / n, 4),
                   "fault_model": "crash"}, f"targeted_f{f}")
        if verbose:
            print(f"  f={f:,}: disagree={pt.disagree_frac:.3f} "
                  f"decided={pt.decided_frac:.3f}", flush=True)
    # past the boundary: livelock, no decisions at all
    f_half = n // 2 + 1
    cfg = SimConfig(n_nodes=n, n_faulty=f_half, trials=trials, max_rounds=16,
                    delivery="quorum", scheduler="targeted",
                    path="histogram", seed=seed)
    pt = _row(cfg, FaultSpec.none(trials, n),
              {"f": f_half, "f_frac": round(f_half / n, 4),
               "fault_model": "crash"}, f"targeted_f{f_half}")
    if verbose:
        print(f"  f={f_half:,} (past 1/2): decided={pt.decided_frac:.3f} "
              f"(livelock)", flush=True)
    # the quirk-born parity effect: an ODD quorum admits no perfect
    # phase-1 tie, so no "?" voters can be manufactured and the attack
    # needs N <= 3F + 1 — one odd-quorum row either side of that bound
    for frac, label in ((0.05, "odd,N>3F+1"), (0.40, "odd,N<3F+1")):
        f = int(frac * n)
        f += 1 - (n - f) % 2               # force an odd quorum
        cfg = SimConfig(n_nodes=n, n_faulty=f, trials=trials, max_rounds=16,
                        delivery="quorum", scheduler="targeted",
                        path="histogram", seed=seed)
        pt = _row(cfg, FaultSpec.none(trials, n),
                  {"f": f, "f_frac": round(f / n, 4),
                   "fault_model": f"crash ({label})"},
                  f"targeted_odd_f{f}")
        if verbose:
            print(f"  f={f:,} ({label}): disagree={pt.disagree_frac:.3f}",
                  flush=True)
    # one equivocator: agreement dies at any N
    cfg = SimConfig(n_nodes=n, n_faulty=1, trials=trials, max_rounds=16,
                    delivery="quorum", scheduler="targeted",
                    fault_model="equivocate", path="histogram", seed=seed)
    pt = _row(cfg, FaultSpec.first_f(cfg),
              {"f": 1, "f_frac": round(1 / n, 7),
               "fault_model": "equivocate"}, "targeted_equivocate_f1",
              fault_policy="default")
    if verbose:
        print(f"  ONE equivocator: disagree={pt.disagree_frac:.3f}",
              flush=True)
    return rows


def ks_two_sample(a, b) -> tuple:
    """Two-sample Kolmogorov–Smirnov (statistic, asymptotic p-value).

    scipy-free (scipy is a test-only extra): the standard asymptotic
    Kolmogorov distribution evaluated at the effective sample size —
    adequate for the discrete round-count laws reported here (the test
    suite cross-checks against scipy where available)."""
    a = np.sort(np.asarray(a, float))
    b = np.sort(np.asarray(b, float))
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    d = float(np.max(np.abs(cdf_a - cdf_b)))
    n_eff = len(a) * len(b) / (len(a) + len(b))
    lam = (np.sqrt(n_eff) + 0.12 + 0.11 / np.sqrt(n_eff)) * d
    # Kolmogorov survival Q(lam): the alternating large-lam series is
    # numerically useless for small lam (identical samples would report
    # p = 0 instead of 1) — use the dual theta-series there, like every
    # standard implementation.
    if lam < 1e-9:
        return d, 1.0
    if lam < 1.18:
        t = np.exp(-np.pi ** 2 / (8.0 * lam ** 2))
        cdf = (np.sqrt(2.0 * np.pi) / lam) * (t + t ** 9 + t ** 25 + t ** 49)
        p = 1.0 - cdf
    else:
        j = np.arange(1, 101)
        p = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * (lam * j) ** 2))
    return d, float(min(max(p, 0.0), 1.0))


def _parity_scenario(n: int, f: int):
    """oracle_parity's scenario: the first f nodes crash-faulty, the
    healthy ones alternating 0 / 1 -> (values, faulty list)."""
    return ([0] * f + [i % 2 for i in range(n - f)],
            [True] * f + [False] * (n - f))


def _parity_sim(trials: int, seed: int, n: int, f: int, device=None):
    """oracle_parity's simulator side: the uniform-quorum histogram run of
    its scenario at N = n x max(8 * trials, 256) on ``device`` -> the
    final NetState."""
    s_seeds = max(trials * 8, 256)
    vals, faulty = _parity_scenario(n, f)
    cfg_t = SimConfig(n_nodes=n, n_faulty=f, trials=s_seeds,
                      delivery="quorum", scheduler="uniform",
                      path="histogram", max_rounds=64, seed=seed + 11)
    faults = FaultSpec.from_faulty_list(cfg_t, faulty,
                                        device=resolve_device(device))
    state = init_state(cfg_t, np.tile(np.asarray(vals, np.int8),
                                      (s_seeds, 1)), faults)
    return run_consensus(cfg_t, state, faults)[1]


def oracle_parity(trials: int, seed: int = 0, n: int = 100, f: int = 40,
                  verbose=True, device=None) -> Dict:
    """Oracle <-> scheduler distribution parity, at a FIXED differential
    scale (N = 100: the oracles are event-loop programs, not tensor
    programs; N does not scale them).

    Three facts, each checked here:
      * decided runs are delivery-order INVARIANT (fifo == shuffle bit for
        bit): with crash faults pinned to F, alive == quorum, so every
        tally holds the whole live population in any order;
      * order-dependence survives only in runs capped mid-coin-phase, and
        there only as a permutation of the coin assignment;
      * hence the per-trial rounds-to-decide law has one source of chance
        (iid fair coins) and matches the simulator's uniform-quorum
        scheduler's law (two-sample KS).

    The oracle side is the native oracle on the host over max(8 * trials,
    256) seeds; the simulator side is ``run_consensus`` at N = 100 x that
    many trials on ``device`` (CUDA unless it names the CPU).
    """
    from .backends import native_oracle

    s_seeds = max(trials * 8, 256)          # oracle seeds are cheap (C++)
    vals, faulty = _parity_scenario(n, f)
    healthy = np.r_[f:n]
    cfg_o = SimConfig(n_nodes=n, n_faulty=f, backend="native",
                      max_rounds=64, oracle_order="shuffle")
    seeds = np.arange(s_seeds, dtype=np.uint32)
    t0 = time.perf_counter()
    # raise_on_cap: a capped seed's state is a mid-run snapshot, not a
    # finished trace — it must not enter the invariance or KS samples
    out_s = native_oracle.run_batch(cfg_o, vals, faulty, seeds,
                                    raise_on_cap=True)
    oracle_elapsed = time.perf_counter() - t0
    out_f = native_oracle.run_batch(cfg_o.replace(oracle_order="fifo"),
                                    vals, faulty, seeds, raise_on_cap=True)
    # the invariance covers DECIDED runs only (a run capped mid-coin-phase
    # permutes its coin assignment): compare seeds decided in both orders
    dec = (out_s["decided"][:, healthy].all(axis=1)
           & out_f["decided"][:, healthy].all(axis=1))
    order_invariant = bool((out_s["x"][dec] == out_f["x"][dec]).all()
                           and (out_s["k"][dec] == out_f["k"][dec]).all())
    # the KS samples hold FINISHED rounds-to-decide values only: a trial
    # that hit max_rounds undecided contributes a censored k
    dec_o = out_s["decided"][:, healthy].all(axis=1)
    if not dec_o.any():
        raise RuntimeError(
            "oracle_parity: every oracle trial was censored at "
            f"max_rounds={cfg_o.max_rounds}; raise max_rounds or shrink "
            "the scenario")
    k_oracle = out_s["k"][dec_o][:, healthy].max(axis=1) - 1

    fin = _parity_sim(trials, seed, n, f, device)
    dec_t = fin.decided.cpu().numpy()[:, healthy].all(axis=1)
    if not dec_t.any():
        raise RuntimeError(
            "oracle_parity: every tpu trial was censored at "
            f"max_rounds={cfg_t.max_rounds}; raise max_rounds or shrink "
            "the scenario")
    k_tpu = fin.k.cpu().numpy()[dec_t][:, healthy].max(axis=1) - 1

    stat, pvalue = ks_two_sample(k_oracle, k_tpu)
    res = {
        "n": n, "f": f, "n_seeds": int(s_seeds),
        "n_decided_both_orders": int(dec.sum()),
        "n_censored": {"oracle": int((~dec_o).sum()),
                       "tpu": int((~dec_t).sum())},
        "order_invariant_decided_runs": order_invariant,
        "oracle_mean_rounds": round(float(k_oracle.mean()), 4),
        "tpu_mean_rounds": round(float(k_tpu.mean()), 4),
        "oracle_round_hist": np.bincount(k_oracle,
                                         minlength=8)[:8].tolist(),
        "tpu_round_hist": np.bincount(k_tpu, minlength=8)[:8].tolist(),
        "ks_statistic": round(stat, 5), "ks_pvalue": round(pvalue, 5),
        "oracle_msgs_per_sec": round(
            float(out_s["steps"].sum()) / max(oracle_elapsed, 1e-9), 1),
    }
    if verbose:
        print(f"  order-invariant (fifo==shuffle, decided): "
              f"{order_invariant}", flush=True)
        print(f"  rounds-to-decide: oracle {res['oracle_round_hist']} "
              f"vs tpu {res['tpu_round_hist']}; "
              f"KS D={stat:.4f} p={pvalue:.3f}", flush=True)
    return res


def rule_comparison(n: int, trials: int, seed: int = 0,
                    f_frac: float = 0.45, verbose=True,
                    device=None) -> List[Dict]:
    """Reference decide rule vs textbook Ben-Or, same workload (balanced
    inputs, f = 0.45, zero crashes).

    The reference adopts the PLURALITY of non-"?" votes before falling
    back to the coin (node.ts:106-112 — SURVEY §2.1 quirk 9); textbook
    Ben-Or coins whenever no value clears > F votes.  Plurality adoption
    is the amplification step that locks the network onto the round-1
    sampling-noise majority — removing it (rule='textbook') forces lanes
    to re-randomize every round, so convergence needs the per-lane vote
    margin itself to clear the threshold.  This quantifies the quirk the
    reference's own k <= 2 test bounds silently depend on.
    """
    rows = []
    for rule in ("reference", "textbook"):
        cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                        max_rounds=64, delivery="quorum",
                        scheduler="uniform", path="histogram", rule=rule,
                        seed=seed, **_flagship_flags(device))
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=FaultSpec.none(trials, n), device=device)
        rows.append({"rule": rule, **pt.to_dict()})
        if verbose:
            print(f"  rule={rule}: mean_k={pt.mean_k:.3f} "
                  f"decided={pt.decided_frac:.3f}", flush=True)
    return rows


def scaling_study(n_large: int, trials: int, seed: int = 0,
                  f_frac: float = 0.45, verbose=True,
                  device=None) -> List[Dict]:
    """Rounds-to-decide and throughput vs network size N at the hardest
    uniform point (balanced inputs, f = 0.45, zero crashes).

    Science: the decide threshold exceeds the typical class count by
    (3f-1)/2 * m ~ O(N) while per-round sampling noise is O(sqrt(N)) — yet
    mean_k stays ~3 at every N, because round 1's plurality-adopt step
    AMPLIFIES the initial sqrt(N)-scale imbalance into a network-wide
    majority (each lane adopts the majority of its own noisy sample, and
    the per-lane adoption bias compounds network-wide in one step).  The
    flat curve is the measurable signature of that amplification.

    Perf: trials/s vs N traces the weak-scaling envelope on one card
    (launch-bound at small N, the round kernels' work at 10^6).
    """
    ns = [10 ** k for k in range(3, 7) if 10 ** k <= n_large]
    if not ns or ns[-1] != n_large:   # always measure the top point itself
        ns.append(n_large)
    rows = []
    for n in ns:
        cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                        max_rounds=64, delivery="quorum",
                        scheduler="uniform", path="histogram", seed=seed,
                        **_flagship_flags(device))
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=FaultSpec.none(trials, n), device=device)
        rows.append({"n": n, **pt.to_dict()})
        if verbose:
            print(f"  N={n:>9,}: mean_k={pt.mean_k:.3f} "
                  f"decided={pt.decided_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    return rows


def trajectory_study(n: int, trials: int, seed: int = 0,
                     f_frac: float = 0.45, n_rounds: int = 8,
                     verbose=True, device=None) -> List[Dict]:
    """Round-resolved convergence dynamics at the hardest uniform point
    (balanced inputs, f = 0.45): the decided fraction jumps 0 -> 1 in one
    round once the sampling-noise random walk amplifies a network-wide
    majority — the trajectory shows WHEN, which the endpoint cannot."""
    cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                    max_rounds=64, delivery="quorum", scheduler="uniform",
                    path="histogram", seed=seed, **_flagship_flags(device))
    faults = FaultSpec.none(trials, n, device=resolve_device(device))
    state = init_state(cfg, _balanced(trials, n), faults)
    _, traj = record_trajectory(cfg, state, faults, n_rounds)
    traj = {k: v.cpu().numpy() for k, v in traj.items()}
    rows = []
    for i in range(n_rounds):
        rows.append({"round": i + 1,
                     **{k: round(float(v[i]), 4) for k, v in traj.items()}})
        if verbose:
            r = rows[-1]
            print(f"  round {r['round']}: decided={r['decided']:.3f} "
                  f"zeros={r['zeros']:.3f} ones={r['ones']:.3f} "
                  f"qs={r['qs']:.3f}", flush=True)
    return rows


#: Weak-coin deviation probabilities: coarse approach + a fine straddle of
#: the predicted critical point eps* = 1 - f (the adversary can tie a coin
#: round iff the deviating minority reaches the tie target m/2, i.e.
#: eps/2 >= (1-f)/2; at N=1M the Binomial(N, eps/2) fluctuation is only
#: ~5e-4 of N, so the transition is knife-edge sharp).
WEAK_COIN_EPS = (0.0, 0.3, 0.5, 0.58, 0.597, 0.603, 0.62, 0.8, 1.0)


def weak_coin_study(n: int, trials: int, seed: int = 0,
                    f_frac: float = 0.40, eps_grid=WEAK_COIN_EPS,
                    verbose=True, device=None) -> List[Dict]:
    """Termination vs coin quality under the count-controlling adversary.

    coin_mode='weak_common' interpolates Rabin-style shared coins
    (eps = 0) and Ben-Or private coins (eps = 1): each lane deviates to a
    private flip with probability eps.  The adversary lives off the
    deviators — it can tie a post-coin round iff the minority class
    reaches m/2 — so termination has a phase transition at eps* = 1 - f,
    located here to ~1e-3 at N=1M."""
    rows = []
    for eps in eps_grid:
        cfg = SimConfig(n_nodes=n, n_faulty=int(f_frac * n), trials=trials,
                        max_rounds=16, delivery="quorum",
                        scheduler="adversarial", coin_mode="weak_common",
                        coin_eps=eps, path="histogram", seed=seed)
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       faults=FaultSpec.none(trials, n), device=device)
        rows.append({"eps": eps, **pt.to_dict()})
        if verbose:
            print(f"  eps={eps}: decided={pt.decided_frac:.3f} "
                  f"mean_k={pt.mean_k:.2f}", flush=True)
    return rows


def equivocation_threshold(n: int, trials: int, seed: int = 0,
                           verbose=True, device=None) -> List[Dict]:
    """Locate the N > 3F bound at scale: equivocators under the
    count-controlling adversary, common coin, balanced inputs.  The two
    middle rows have opposite fates across the bound: the largest F with
    3F < N strictly, and the smallest with 3F > N.  They are one node
    apart except when N % 3 == 0, where 3*(N//3) == N is already past the
    bound (it livelocks), so the sub row steps down one (same guard as
    bench.py's equiv_3f_sub) and the rows bracket the boundary two
    apart."""
    f_sub = n // 3 - (1 if n % 3 == 0 else 0)   # largest F with 3F < N
    sub_label = "N//3-1" if n % 3 == 0 else "N//3"
    rows = []
    for f, label in ((int(0.30 * n), "0.30*N"), (f_sub, sub_label),
                     (n // 3 + 1, "N//3+1"), (int(0.36 * n), "0.36*N")):
        cfg = SimConfig(n_nodes=n, n_faulty=f, trials=trials, max_rounds=16,
                        delivery="quorum", scheduler="adversarial",
                        coin_mode="common", fault_model="equivocate",
                        path="histogram", seed=seed)
        pt = run_point(cfg, initial_values=_balanced(trials, n),
                       device=device)
        rows.append({"f": f, "label": label, "three_f_lt_n": 3 * f < n,
                     **pt.to_dict()})
        if verbose:
            print(f"  F={label} ({f:,}): decided={pt.decided_frac:.3f} "
                  f"mean_k={pt.mean_k:.2f} rounds={pt.rounds_executed}",
                  flush=True)
    return rows


def coin_contrast(n: int, trials: int, seed: int = 0,
                  f_frac: float = 0.20,
                  device=None) -> Dict[str, List[SweepPoint]]:
    f = int(f_frac * n)
    f += (n - f) % 2                       # even quorum for a perfect tie
    cfg = SimConfig(n_nodes=n, n_faulty=f, trials=trials, max_rounds=16,
                    seed=seed, path="histogram")
    return coin_comparison(cfg, device=device)


def topo_curves(n: int, trials: int, seed: int = 0,
                max_rounds: int = 32, verbose: bool = False,
                device=None) -> Dict:
    """The structured-delivery science rows: rounds-to-decide against
    degree and diameter over the default ring / torus / random-regular
    ladder (the neighbourhood-unanimity bar, topo/curves.unanimity_fault),
    and the committee-size sweep at committee count 4, one dynamic bucket,
    whose build count rides the return."""
    from .topo.curves import (committee_curve, default_degree_specs,
                              degree_curve)

    base = SimConfig(n_nodes=n, n_faulty=0, trials=trials,
                     max_rounds=max_rounds, seed=seed)
    deg_rows = degree_curve(base, default_degree_specs(n),
                            verbose=verbose, device=device)
    # sizes stay <= N / committee_count: past it the participation
    # probability clips at 1 and every size draws the same membership
    sizes = sorted({max(2, n // 16), max(3, n // 8), max(4, n // 4)})
    com_rows, cb = committee_curve(base.replace(n_faulty=1), sizes=sizes,
                                   committee_count=4, verbose=verbose,
                                   device=device)
    return {"degree_curve": deg_rows, "committee_curve": com_rows,
            "committee_compile_count": cb.compile_count,
            "committee_buckets": cb.n_buckets}


def faults_curves(n: int, trials: int, seed: int = 0,
                  max_rounds: int = 32, verbose: bool = False,
                  device=None) -> Dict:
    """The faultlab science rows (faults/curves.py): the paper's
    probabilistic-termination claim stress-tested along the two dynamic
    fault axes —

      * rounds-to-decide vs per-edge omission probability
        (``drop_curve``): the whole p grid is ONE dynamic bucket
        (drop_prob rides DynParams; the bucket count rides the
        return).  The grid stays below the stall threshold p ~ F/N —
        beyond it the expected delivered count drops under the quorum
        N - F and every lane stalls to the round cap (the curve's
        asymptote, not its interesting region);
      * rounds-to-decide vs crash-recovery churn (``churn_curve``): a
        rolling ``stagger:2:<down>`` schedule with growing down length —
        deeper churn holds more of the quorum slack hostage per round.

    Rows are json-ready dicts, the JAX package's."""
    from .faults.curves import churn_curve, drop_curve

    f = max(n // 4, 1)
    base = SimConfig(n_nodes=n, n_faulty=f, trials=trials,
                     max_rounds=max_rounds, seed=seed)
    # omission grid: up to ~60% of the stall threshold F/N, so the curve
    # bends without saturating at the cap
    frac = f / n
    ps = [round(frac * s, 6) for s in (0.1, 0.25, 0.4, 0.6)]
    drop_rows, drop_cb = drop_curve(base, ps, verbose=verbose,
                                    device=device)
    churn_rows, churn_cb = churn_curve(
        base.replace(n_faulty=max(n // 8, 1)), down_lengths=(1, 3, 6),
        verbose=verbose, device=device)
    return {"drop_curve": drop_rows,
            "drop_compile_count": drop_cb.compile_count,
            "drop_buckets": drop_cb.n_buckets,
            "churn_curve": churn_rows,
            "churn_compile_count": churn_cb.compile_count}


def generate(out_dir: str = "RESULTS", n_large: int = 1_000_000,
             trials_large: int = 32, seed: int = 0,
             presets=True, device=None) -> Dict[str, object]:
    """Run every study, write JSON artifacts + RESULTS.md, return the data.
    Runs on CUDA unless ``device`` names the CPU; on the card the studies
    that take the flagship flags run on the round kernels.  The oracle
    parity study runs where g++ builds the native oracle, and is skipped,
    its key left out, where there is none, as in the JAX package."""
    os.makedirs(out_dir, exist_ok=True)
    platform, kind = device_identity(device)
    meta = {"device": kind, "platform": platform, "n_large": n_large,
            "trials_large": trials_large, "seed": seed}
    out: Dict[str, object] = {"meta": meta}

    print(f"results: device={kind} N={n_large}", flush=True)
    if _flagship_flags(device):
        meta["flagship_pallas"] = True
        print("  flagship kernels: armed (use_pallas_hist, "
              "use_pallas_round)", flush=True)

    print("balanced rounds-vs-f curve:", flush=True)
    pts = balanced_curve(n_large, trials_large, seed, device=device)
    out["balanced_curve"] = [
        {"f_frac": fr, **p.to_dict()} for fr, p in zip(CURVE_FRACS, pts)]

    print("margin sweep (f=0.40):", flush=True)
    out["margin_sweep"] = margin_sweep(n_large, trials_large, seed,
                                       device=device)

    print("coin contrast (adversarial):", flush=True)
    cc = coin_contrast(n_large, trials_large, seed, device=device)
    out["coin_contrast"] = {k: [p.to_dict() for p in v]
                            for k, v in cc.items()}

    print("disagreement vs adversary strength (f=0.25):", flush=True)
    out["disagreement"] = disagreement_sweep(n_large, trials_large, seed,
                                             out_dir=out_dir, device=device)

    print("safety violation under the targeted adversary:", flush=True)
    out["safety_violation"] = safety_violation(n_large, trials_large, seed,
                                               out_dir=out_dir,
                                               device=device)

    print("equivocation: the N > 3F bound at scale:", flush=True)
    out["equivocation"] = equivocation_threshold(n_large, trials_large, seed,
                                                 device=device)

    print("convergence trajectory (f=0.45, balanced):", flush=True)
    out["trajectory"] = trajectory_study(n_large, trials_large, seed,
                                         device=device)

    print("scaling: rounds + throughput vs N (f=0.45, balanced):",
          flush=True)
    out["scaling"] = scaling_study(n_large, trials_large, seed,
                                   device=device)

    print("decision rule: reference vs textbook (f=0.45, balanced):",
          flush=True)
    out["rule_comparison"] = rule_comparison(n_large, trials_large, seed,
                                             device=device)

    print("weak common coin: termination vs eps (f=0.40, adversary):",
          flush=True)
    out["weak_coin"] = weak_coin_study(n_large, trials_large, seed,
                                       device=device)

    from .backends.native_oracle import native_available
    if native_available():
        print("oracle<->scheduler distribution parity (N=100):", flush=True)
        out["oracle_parity"] = oracle_parity(trials_large, seed,
                                             device=device)
    else:
        print("oracle parity: skipped (no g++)", flush=True)

    if presets:
        from .serve.jobs import JobSpec
        for name, cfg in baseline_configs().items():
            if cfg.n_nodes > n_large:      # CPU smoke scaling
                continue
            print(f"preset {name}:", flush=True)
            pt = run_point(cfg, device=device)
            print(f"  mean_k={pt.mean_k:.3f} decided={pt.decided_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
            row = pt.to_dict()
            # the job document that replays this row through the request
            # plane (`POST /v1/jobs` on `python -m benor_tpu_torch serve`)
            row["serve_replay"] = JobSpec.from_config(cfg).to_dict()
            out[f"preset_{name}"] = row

    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    _write_markdown(out_dir, out)
    print(f"results: wrote {out_dir}/results.json and {out_dir}/RESULTS.md",
          flush=True)
    return out


def _write_markdown(out_dir: str, out: Dict) -> None:
    meta = out["meta"]
    lines = [
        "# RESULTS — expected-rounds curves (BASELINE.json north star)",
        "",
        f"Generated on `{meta['device']}` ({meta['platform']}), "
        f"N={meta['n_large']:,}, {meta['trials_large']} MC trials, "
        f"seed={meta['seed']}.  Regenerate with "
        "`python -m benor_tpu_torch results`.",
        "",
        "## Expected rounds vs fault fraction "
        "(balanced inputs, zero crashes)",
        "",
        "Decide threshold is `count > F` of `m = N-F` tallied votes: for "
        "f > 1/3 the threshold exceeds the typical class count m/2 and "
        "deciding requires the sampling-noise random walk to amplify a "
        "network-wide majority first.",
        "",
        "(ones frac = 0.000 for f < 1/3 is the reference's decide0-first "
        "quirk, node.ts:99-104: with balanced votes BOTH classes exceed F, "
        "and the 0-branch is checked first — every lane decides 0.)",
        "",
        "| f | mean k | decided | ones frac | trials/s |",
        "|---|---|---|---|---|",
    ]
    for row in out["balanced_curve"]:
        lines.append(
            f"| {row['f_frac']:.2f} | {row['mean_k']:.3f} "
            f"| {row['decided_frac']:.3f} | {row['ones_frac']:.3f} "
            f"| {row['trials_per_sec']:.1f} |")
    lines += [
        "",
        "## Rounds vs initial margin (f = 0.40)",
        "",
        "1-count = N/2 + delta*sqrt(N)/2 per trial: the transition from "
        "sampling-noise-dominated (multi-round) to margin-dominated "
        "(1-round) decisions.",
        "",
        "| delta (x sqrt(N)) | mean k | ones frac |",
        "|---|---|---|",
    ]
    for row in out["margin_sweep"]:
        lines.append(f"| {row['delta']} | {row['mean_k']:.3f} "
                     f"| {row['ones_frac']:.3f} |")
    cc = out["coin_contrast"]
    priv, comm = cc["private"][0], cc["common"][0]
    lines += [
        "",
        "## Private vs common coin under the count-controlling adversary",
        "",
        "The adversary delivers every receiver a tied 0/1 multiset; private "
        "coins cannot break network-wide symmetry (livelock at the round "
        "cap), the shared common coin does so in O(1) expected rounds — "
        "the Ben-Or vs Rabin contrast at N=1M:",
        "",
        "| coin | decided | mean k | rounds executed |",
        "|---|---|---|---|",
        f"| private | {priv['decided_frac']:.3f} | {priv['mean_k']:.2f} "
        f"| {priv['rounds_executed']} |",
        f"| common | {comm['decided_frac']:.3f} | {comm['mean_k']:.2f} "
        f"| {comm['rounds_executed']} |",
        "",
        "## Agreement-safety violations vs split-adversary strength "
        "(f = 0.25)",
        "",
        "The reference's decide rule `count > F` is only safe while at most "
        "N-F senders are alive (its crash model guarantees that).  With all "
        "N alive, a delay adversary that starves even receivers of 1s and "
        "odd receivers of 0s makes the two halves decide OPPOSITE values — "
        "`disagree` is the fraction of trials whose decided healthy nodes "
        "hold both values.  (Every s >= 1 is exact strict priority on the "
        "histogram path — the curve is flat beyond 1.0 by construction.)",
        "",
        "| strength s | disagree | decided | mean k | ones frac |",
        "|---|---|---|---|---|",
    ]
    for row in out["disagreement"]:
        lines.append(
            f"| {row['strength']} | {row['disagree_frac']:.3f} "
            f"| {row['decided_frac']:.3f} | {row['mean_k']:.2f} "
            f"| {row['ones_frac']:.3f} |")
    if "safety_violation" in out:
        lines += [
            "",
            "## Agreement under the TARGETED (partitioned) adversary",
            "",
            "The worst case of the \"first N−F arrivals win\" "
            "nondeterminism (node.ts:52,88): nothing forces two receivers "
            "to tally the same multiset.  The targeted scheduler seeds F+1 "
            "receivers to decide 0, F+1 to decide 1, and feeds the rest "
            "perfect ties so their \"?\" votes (counted toward quorums by "
            "quirk 4) starve the 1-camp's zero-count under the bar.  Where "
            "the delay-bounded split adversary above has a soft "
            "probabilistic transition, this curve is exactly 0/1: "
            "agreement is violated at EVERY 1 ≤ F < N/2 (even quorum), "
            "and at f ≥ 1/2 the bar `count > F` is unreachable — livelock. "
            "The `odd` rows show the quirk-born parity effect: an odd "
            "quorum admits no perfect phase-1 tie, no \"?\" voters can be "
            "manufactured, and the attack weakens to N ≤ 3F + 1. "
            "The final row arms ONE equivocator: the decide rule has no "
            "Byzantine safety margin at any N.  Every violating row was "
            "auto-rerun with the witness recorder armed and machine-"
            "checked by the invariant auditor (benor_tpu_torch/audit.py); "
            "the "
            "pinpointed (trial, round, node, tallies) witness bundles "
            "sit next to this file as `witness_*.json`.",
            "",
            "| F | fault model | disagree | decided | mean k |",
            "|---|---|---|---|---|",
        ]
        for row in out["safety_violation"]:
            lines.append(
                f"| {row['f']:,} | {row['fault_model']} "
                f"| {row['disagree_frac']:.3f} | {row['decided_frac']:.3f} "
                f"| {row['mean_k']:.2f} |")
    if "oracle_parity" in out:
        op = out["oracle_parity"]
        lines += [
            "",
            "## Oracle ↔ scheduler distribution parity (SURVEY hard-part 1)",
            "",
            "Within the reference contract, crash faults are pinned to "
            "exactly F, so alive == quorum and every tally holds the FULL "
            "live population in any delivery order — the event-loop "
            "asynchrony is *tally-invisible* in the reference's own "
            "scenario space.  Decided runs are delivery-order-invariant "
            f"(fifo == shuffle bit-identically: "
            f"{op['order_invariant_decided_runs']}), order-dependence "
            "survives only as a coin-assignment permutation in runs capped "
            "mid-coin-phase, and the per-trial rounds-to-decide law — "
            "driven solely by iid fair coins — matches the tpu "
            "uniform-quorum scheduler's:",
            "",
            f"- N={op['n']}, F={op['f']}, {op['n_seeds']} seeds/trials "
            "(balanced healthy inputs, every round a coin round)",
            f"- oracle rounds histogram: `{op['oracle_round_hist']}` "
            f"(mean {op['oracle_mean_rounds']})",
            f"- tpu    rounds histogram: `{op['tpu_round_hist']}` "
            f"(mean {op['tpu_mean_rounds']})",
            f"- two-sample KS: D = {op['ks_statistic']}, "
            f"p = {op['ks_pvalue']}",
        ]
    if "equivocation" in out:
        lines += [
            "",
            "## The N > 3F bound, located to ±1 node at N = 10⁶",
            "",
            "Equivocators (per-receiver Byzantine values) controlled by the "
            "count-controlling adversary, against the shared common coin: "
            "at F ≥ N/3 the adversary's free pool covers the tie deficit of "
            "every tally forever (the classic impossibility); at F < N/3 a "
            "coin-unified honest class forces m − F > F votes and decides. "
            "The middle rows differ by ONE node out of a million:",
            "",
            "| F | 3F < N | decided | mean k | rounds executed |",
            "|---|---|---|---|---|",
        ]
        for row in out["equivocation"]:
            lines.append(
                f"| {row['label']} = {row['f']:,} | {row['three_f_lt_n']} "
                f"| {row['decided_frac']:.3f} | {row['mean_k']:.2f} "
                f"| {row['rounds_executed']} |")
    if "scaling" in out:
        lines += [
            "",
            "## Scaling: rounds and throughput vs N (f = 0.45, balanced)",
            "",
            "The decide threshold exceeds the typical class count by O(N) "
            "while sampling noise is only O(√N) — yet mean k stays flat, "
            "because round 1's plurality-adopt step amplifies the initial "
            "√N-scale imbalance into a network-wide majority in one round. "
            "trials/s traces the single-chip weak-scaling envelope "
            "(dispatch-bound at small N, bandwidth-bound at 10⁶).",
            "",
            "| N | mean k | decided | trials/s |",
            "|---|---|---|---|",
        ]
        for row in out["scaling"]:
            lines.append(
                f"| {row['n']:,} | {row['mean_k']:.3f} "
                f"| {row['decided_frac']:.3f} "
                f"| {row['trials_per_sec']:.1f} |")
    if "weak_coin" in out:
        lines += [
            "",
            "## Weak common coin: termination vs deviation probability ε "
            "(f = 0.40)",
            "",
            "`coin_mode='weak_common'` interpolates shared (ε = 0) and "
            "private (ε = 1) coins: each lane deviates to a private flip "
            "with probability ε. The count-controlling adversary can tie a "
            "post-coin round iff the deviating minority reaches m/2, so "
            "termination flips at ε\\* = 1 − f — located below to ~10⁻³ at "
            "N = 10⁶ (weak coins *almost* as bad as ε\\* still terminate; "
            "slightly past it, livelock):",
            "",
            "| ε | decided | mean k | rounds executed |",
            "|---|---|---|---|",
        ]
        for row in out["weak_coin"]:
            lines.append(
                f"| {row['eps']} | {row['decided_frac']:.3f} "
                f"| {row['mean_k']:.2f} | {row['rounds_executed']} |")
    if "rule_comparison" in out:
        lines += [
            "",
            "## Decision rule: reference (plurality-adopt) vs textbook",
            "",
            "The reference adopts the plurality of non-\"?\" votes before "
            "coining (node.ts:106-112, quirk 9) — the amplification step "
            "that locks the network onto round 1's sampling-noise majority. "
            "Textbook Ben-Or (coin whenever no value clears > F votes) "
            "lacks it; `rule='textbook'` quantifies what the reference's "
            "own k ≤ 2 test bounds silently depend on:",
            "",
            "| rule | mean k | decided |",
            "|---|---|---|",
        ]
        for row in out["rule_comparison"]:
            lines.append(f"| {row['rule']} | {row['mean_k']:.3f} "
                         f"| {row['decided_frac']:.3f} |")
    if "trajectory" in out:
        lines += [
            "",
            "## Convergence trajectory (f = 0.45, balanced inputs)",
            "",
            "Round-resolved dynamics from `sweep.record_trajectory` (one "
            "compiled scan, on-device reductions): the decided fraction "
            "jumps 0 → 1 in a single round once sampling noise amplifies a "
            "network-wide majority; `zeros`/`ones`/`qs` are the live "
            "healthy lanes' value shares after each round.",
            "",
            "| round | decided | zeros | ones | qs | disagree |",
            "|---|---|---|---|---|---|",
        ]
        for row in out["trajectory"]:
            lines.append(
                f"| {row['round']} | {row['decided']:.3f} "
                f"| {row['zeros']:.3f} | {row['ones']:.3f} "
                f"| {row['qs']:.3f} | {row['disagree']:.3f} |")
    lines += [
        "",
        "## BASELINE.json presets",
        "",
        "As literally specified: crash-from-birth faults pin the live "
        "population to exactly the quorum N-F, so every receiver tallies "
        "the whole population deterministically and iid inputs decide in "
        "one round (mean k ~ 2) — including the adversarial preset, whose "
        "scheduler has no delivery slack to exploit.  The studies above "
        "decouple F from the crash count (zero crashes) to expose the "
        "multi-round regimes.",
        "",
        "| preset | N | F | trials | mean k | decided | trials/s |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, row in out.items():
        if not key.startswith("preset_"):
            continue
        lines.append(
            f"| {key[7:]} | {row['n_nodes']:,} | {row['n_faulty']:,} "
            f"| {row['trials']} | {row['mean_k']:.3f} "
            f"| {row['decided_frac']:.3f} | {row['trials_per_sec']:.1f} |")
    lines.append("")
    with open(os.path.join(out_dir, "RESULTS.md"), "w") as fh:
        fh.write("\n".join(lines))
