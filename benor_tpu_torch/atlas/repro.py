"""Minimal-repro emission and bit-identical replay, ``kind: atlas_repro``
(port of benor_tpu/atlas/repro.py).

Every violation or stall the search (or results.py's safety studies)
finds becomes one replayable JSON document: the full frozen SimConfig,
the input and fault POLICY (never raw arrays: both derive from the config
alone), the recorded verdict and a canonical digest
(``gate.repro_digest``).

The emitter SHRINKS before it writes: trials, nodes (with n_faulty
rescaled to keep F/N) and max_rounds are halved greedily while the
verdict (the decided or stalled side and the violation flag) is kept, so
the artifact is the smallest witness of the phenomenon.  ``replay_repro``
re-runs the exact config through ``sweep.run_point`` (same seed, same
input policy, same fault mask) and pins the summary bit for bit.

The config document is ``dataclasses.asdict`` of a SimConfig whose fields
are the JAX package's, in its order, so a repro's digest is the same in
both packages and a repro written by either replays on the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

from . import gate

#: Record tag of one replayable repro document.
REPRO_KIND = "atlas_repro"

#: Shrink floors: below these the phenomenon degenerates into the
#: config validators' territory rather than smaller evidence.
MIN_TRIALS, MIN_NODES, MIN_ROUNDS = 1, 8, 2

#: SimConfig fields that are tuples (JSON round-trips them as lists).
_TUPLE_FIELDS = ("witness_trials", "mesh_shape")


def _cfg_to_doc(cfg) -> Dict:
    d = dataclasses.asdict(cfg)
    for k in _TUPLE_FIELDS:
        if isinstance(d.get(k), tuple):
            d[k] = list(d[k])
    return d


def _cfg_from_doc(doc: Dict):
    from ..config import SimConfig
    d = dict(doc)
    for k in _TUPLE_FIELDS:
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    return SimConfig(**d)


def _inputs_for(cfg, inputs: str):
    from ..sweep import balanced_inputs, random_inputs
    if inputs == "random":
        return random_inputs(cfg.seed, cfg.trials, cfg.n_nodes)
    if inputs == "balanced":
        return balanced_inputs(cfg.trials, cfg.n_nodes)
    if inputs == "ones":
        import numpy as np
        return np.ones((cfg.trials, cfg.n_nodes), np.int8)
    raise ValueError(f"unknown repro input policy {inputs!r} "
                     f"(random | balanced | ones)")


def _faults_for(cfg, faults: str, device=None):
    if faults == "none":
        from ..state import FaultSpec
        return FaultSpec.none(cfg.trials, cfg.n_nodes, device=device)
    if faults == "default":
        return None               # run_point's first-F-faulty policy
    raise ValueError(f"unknown repro fault policy {faults!r} "
                     f"(none | default)")


def run_verdict(cfg, inputs: str = "random", faults: str = "default",
                device=None) -> Dict:
    """One oracle evaluation -> the verdict block a repro records.
    ``verdict`` is the stall/decide side (majority of trials), the
    floats are the exact run_point summaries (bit-identity anchors)."""
    from ..sweep import run_point
    pt = run_point(cfg, initial_values=_inputs_for(cfg, inputs),
                   faults=_faults_for(cfg, faults), device=device)
    stall = 1.0 - pt.decided_frac
    return {"verdict": "stalled" if stall >= 0.5 else "decided",
            "rounds_executed": int(pt.rounds_executed),
            "decided_frac": float(pt.decided_frac),
            "mean_k": float(pt.mean_k),
            "disagree_frac": float(pt.disagree_frac),
            "violation": bool(pt.disagree_frac > 0)}


def _preserved(expect: Dict, got: Dict) -> bool:
    """Shrink acceptance: the same stall/decide side and violation flag
    (the floats move with scale; the phenomenon must not)."""
    return (got["verdict"] == expect["verdict"]
            and got["violation"] == expect["violation"])


def _shrink_candidates(cfg):
    """The next generation of smaller configs, largest reduction first.
    Invalid combinations (a partition that no longer splits, a ring
    degree >= N) are rejected by SimConfig validation and skipped."""
    out = []
    if cfg.trials // 2 >= MIN_TRIALS:
        out.append({"trials": cfg.trials // 2})
    n2 = cfg.n_nodes // 2
    if n2 >= MIN_NODES:
        # preserve the F/N ratio — every cliff in the atlas is a ratio
        out.append({"n_nodes": n2,
                    "n_faulty": max(0, round(cfg.n_faulty * n2
                                             / cfg.n_nodes))})
    if cfg.max_rounds // 2 >= MIN_ROUNDS:
        out.append({"max_rounds": cfg.max_rounds // 2})
    return out


def build_repro(cfg, inputs: str = "random", faults: str = "default",
                label: str = "", shrink: bool = True,
                max_steps: int = 16, device=None) -> Dict:
    """Shrink ``cfg`` while its verdict is preserved, then emit the
    replayable document (digest included, verdict re-measured at the
    final size so replay is bit-identical by construction)."""
    expect = run_verdict(cfg, inputs, faults, device)
    steps = 0
    shrunk_from = {"trials": cfg.trials, "n_nodes": cfg.n_nodes,
                   "max_rounds": cfg.max_rounds}
    while shrink and steps < max_steps:
        for repl in _shrink_candidates(cfg):
            try:
                cand = cfg.replace(**repl)
            except ValueError:
                continue
            got = run_verdict(cand, inputs, faults, device)
            if _preserved(expect, got):
                cfg, expect, steps = cand, got, steps + 1
                break
        else:
            break
    doc = {"kind": REPRO_KIND, "schema_version": gate.SCHEMA_VERSION,
           "label": str(label), "config": _cfg_to_doc(cfg),
           "inputs": inputs, "faults": faults, "verdict": expect,
           "shrunk_from": shrunk_from, "shrink_steps": steps}
    doc["digest"] = gate.repro_digest(doc)
    return doc


def save_repro(path: str, doc: Dict) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)


def load_repro(path: str) -> Dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != REPRO_KIND:
        raise ValueError(
            f"{os.path.basename(path)}: not an atlas_repro document "
            f"(kind={doc.get('kind')!r})")
    return doc


def replay_repro(doc: Dict, device=None) -> Dict:
    """Re-execute a repro document and pin it bit for bit.

    ``ok`` requires the digest to recompute (the document is what the
    emitter wrote) AND the fresh summary to equal the recorded one
    exactly — rounds, decided/mean_k/disagree floats, verdict side."""
    digest_ok = gate.repro_digest(doc) == doc.get("digest")
    cfg = _cfg_from_doc(doc["config"])
    fresh = run_verdict(cfg, doc["inputs"], doc["faults"], device)
    expect = doc["verdict"]
    bit_identical = all(fresh[k] == expect.get(k) for k in fresh)
    return {"ok": bool(digest_ok and bit_identical),
            "digest_ok": digest_ok, "bit_identical": bit_identical,
            "verdict": fresh, "expected": expect}
