"""The structured planes' science curves: rounds-to-decide against degree
and committee axes (port of benor_tpu/topo/curves.py:36-162), on the
batched engine (``sweep.run_points_batched``).

``degree_curve`` runs one point per topology spec (each a bucket of its
own: the adjacency differs) and returns rows sorted by degree, with each
spec's degree and diameter; ``committee_curve`` sweeps the committee size
or count at a fixed cap, one dynamic bucket (the knobs ride
``DynParams``).  Rows are plain dicts, the JAX package's rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ..config import SimConfig
from .graphs import parse_topology


def default_degree_specs(n_nodes: int) -> List[str]:
    """The default degree ladder at N nodes: rings of degree 2, 4 and 8, a
    square torus where N is a square (side >= 3), a random-regular point."""
    side = int(math.isqrt(n_nodes))
    specs = ["ring:2", "ring:4", "ring:8"]
    if side * side == n_nodes and side >= 3:
        specs.append(f"torus2d:{side}x{side}")
    specs.append("random_regular:6:1")
    return specs


def unanimity_fault(spec_str: str) -> int:
    """The degree curve's default F for one spec: F = d, so deciding needs
    a unanimous d + 1 neighbourhood (a laxer bar decides in round 1 on
    random inputs and flattens the curve).  'complete' is refused: it is
    the baseline, with no degree axis."""
    spec = parse_topology(spec_str)
    if spec is None:
        raise ValueError(
            "'complete' has no degree axis — it is the baseline, not a "
            "curve point; run it through sweep.run_point/"
            "run_curve_batched without a topology instead")
    return spec.degree


def degree_curve(base_cfg: SimConfig, specs: Sequence[str],
                 n_faulty_for=None, initial_values=None,
                 verbose: bool = False, device=None) -> List[Dict]:
    """One point per topology spec through the batched engine -> rows
    sorted by degree.  ``n_faulty_for(spec) -> F`` defaults to
    ``unanimity_fault``; inputs default to per-trial random bits; no node
    crashes (F is the neighbourhood decide bar alone)."""
    from ..state import FaultSpec
    from ..sweep import run_points_batched

    for s in specs:
        if parse_topology(s) is None:
            raise ValueError(
                "degree_curve sweeps adjacency specs; 'complete' is "
                "the baseline, not a curve point (it has no degree "
                "axis) — measure it via sweep.run_point/"
                "run_curve_batched on the untopologized config")
    nf = n_faulty_for if n_faulty_for is not None else unanimity_fault
    cfgs = [base_cfg.replace(topology=s, n_faulty=int(nf(s)))
            for s in specs]
    cb = run_points_batched(
        base_cfg, cfgs, initial_values=initial_values,
        faults_for=lambda c: FaultSpec.none(c.trials, c.n_nodes),
        verbose=verbose, device=device)
    rows = []
    for cfg_f, spec_str, pt in zip(cfgs, specs, cb.points):
        spec = parse_topology(spec_str)
        rows.append({"spec": spec.spec_string(),
                     **spec.metadata(cfg_f.n_nodes),
                     "n_nodes": cfg_f.n_nodes,
                     "n_faulty": cfg_f.n_faulty,
                     "rounds_executed": pt.rounds_executed,
                     "mean_k": round(pt.mean_k, 4),
                     "decided_frac": round(pt.decided_frac, 4),
                     "ones_frac": round(pt.ones_frac, 4),
                     "disagree_frac": round(pt.disagree_frac, 4)})
    rows.sort(key=lambda r: (r["degree"], r["spec"]))
    return rows


def committee_curve(base_cfg: SimConfig,
                    sizes: Optional[Sequence[int]] = None,
                    counts: Optional[Sequence[int]] = None,
                    committee_count: int = 4, committee_size: int = 16,
                    cap: Optional[int] = None,
                    verbose: bool = False, device=None):
    """Sweep the committee size or count -> (rows, BatchedCurve).  Exactly
    one of ``sizes`` / ``counts`` is the axis; the other knob is held at
    ``committee_count`` / ``committee_size``.  Every point shares the cap
    (default: the largest count in play), so the curve is one dynamic
    bucket."""
    from ..state import FaultSpec
    from ..sweep import run_points_batched

    if (sizes is None) == (counts is None):
        raise ValueError("sweep exactly one of sizes= / counts=")
    if counts is not None:
        g_cap = int(cap if cap is not None else max(counts))
        cfgs = [base_cfg.replace(committee_cap=g_cap,
                                 committee_count=int(g),
                                 committee_size=committee_size)
                for g in counts]
    else:
        g_cap = int(cap if cap is not None else committee_count)
        cfgs = [base_cfg.replace(committee_cap=g_cap,
                                 committee_count=committee_count,
                                 committee_size=int(c))
                for c in sizes]
    cb = run_points_batched(
        base_cfg, cfgs,
        faults_for=lambda c: FaultSpec.none(c.trials, c.n_nodes),
        verbose=verbose, device=device)
    rows = []
    for cfg_f, pt in zip(cfgs, cb.points):
        rows.append({"committee_size": cfg_f.committee_size,
                     "committee_count": cfg_f.committee_count,
                     "committee_cap": cfg_f.committee_cap,
                     "n_nodes": cfg_f.n_nodes,
                     "n_faulty": cfg_f.n_faulty,
                     "rounds_executed": pt.rounds_executed,
                     "mean_k": round(pt.mean_k, 4),
                     "decided_frac": round(pt.decided_frac, 4),
                     "disagree_frac": round(pt.disagree_frac, 4)})
    return rows, cb
