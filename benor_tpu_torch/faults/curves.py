"""The faultlab science rows (port of benor_tpu/faults/curves.py):
rounds-to-decide against the per-edge omission probability
(``drop_curve``) and against crash-recovery churn (``churn_curve``), both
through the batched engine (``sweep.run_points_batched``).

``drop_prob`` rides ``DynParams``, so the whole omission curve is one
dynamic bucket; a ``recovery`` spec is static config, so each churn point
is a bucket of its own.  Rows are plain dicts, the JAX package's rows.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..config import SimConfig


def drop_curve(base: SimConfig, drop_probs: Sequence[float],
               verbose: bool = False,
               device=None) -> Tuple[List[Dict], object]:
    """Rounds-to-decide against the omission probability -> (rows, the
    BatchedCurve).  Every point arms the omission plane (drop_prob > 0):
    p = 0 is the injection-off config, which buckets apart.

    No node crashes (FaultSpec.none): crash-from-birth faults pin the live
    population to the quorum N - F, so any drop would stall every
    receiver.  With all N alive the slack F absorbs the thinning, and the
    delivered count crosses the bar near p ~ F/N."""
    from ..state import FaultSpec
    from ..sweep import run_points_batched

    ps = [float(p) for p in drop_probs]
    if any(p <= 0.0 for p in ps):
        raise ValueError(
            "drop_curve sweeps the ARMED omission plane (drop_prob > 0); "
            "p = 0 is the injection-off config and buckets separately — "
            "run it as its own baseline point")
    cfgs = [base.replace(drop_prob=p) for p in ps]
    T, N = base.trials, base.n_nodes
    cb = run_points_batched(base.replace(drop_prob=ps[0]), cfgs,
                            faults_for=lambda c: FaultSpec.none(T, N),
                            verbose=verbose, device=device)
    rows = [{"drop_prob": p, "n_nodes": pt.n_nodes,
             "n_faulty": pt.n_faulty, "trials": pt.trials,
             "mean_k": pt.mean_k, "decided_frac": pt.decided_frac,
             "rounds_executed": pt.rounds_executed}
            for p, pt in zip(ps, cb.points)]
    return rows, cb


def churn_curve(base: SimConfig, down_lengths: Sequence[int],
                crash_round: int = 2, verbose: bool = False,
                device=None) -> Tuple[List[Dict], object]:
    """Rounds-to-decide against churn severity -> (rows, BatchedCurve).

    Each point runs ``fault_model='crash_recover'`` under a rolling
    ``stagger:<crash_round>:<down>`` schedule; the down length is the
    severity axis (a lane that never rejoins is ``crash_at_round``, a
    different plane, so lengths start at 1)."""
    from ..sweep import run_points_batched

    downs = [int(d) for d in down_lengths]
    if any(d < 1 for d in downs):
        raise ValueError("churn_curve needs down lengths >= 1 (a lane "
                         "that never rejoins is crash_at_round, not "
                         "churn)")
    cfgs = [base.replace(fault_model="crash_recover",
                         recovery=f"stagger:{int(crash_round)}:{d}")
            for d in downs]
    cb = run_points_batched(cfgs[0], cfgs, verbose=verbose, device=device)
    rows = [{"down_rounds": d, "recovery": c.recovery,
             "n_nodes": pt.n_nodes, "n_faulty": pt.n_faulty,
             "trials": pt.trials, "mean_k": pt.mean_k,
             "decided_frac": pt.decided_frac,
             "rounds_executed": pt.rounds_executed}
            for d, c, pt in zip(downs, cfgs, cb.points)]
    return rows, cb
