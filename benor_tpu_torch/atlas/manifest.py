"""Phase-atlas capture: the ``kind: atlas_manifest`` document (port of
benor_tpu/atlas/manifest.py).

One capture runs the named searches (each an adaptive
:func:`~benor_tpu_torch.atlas.search.find_cliffs` drive over ONE
validated regime) and stamps the platform and scale identity the gate
keys comparability on.  The three shipped searches pin the regimes the
science studies mapped:

  ``omission``   message-omission stall cliff near p ~ F/N on the
                 histogram path (drop_prob axis — ONE dynamic bucket a
                 generation);
  ``partition``  halves-partition liveness boundary at heal_round ==
                 max_rounds (unanimous inputs, no process faults: pure
                 liveness-NOT-safety — the forensic audit of the
                 stalled side comes back clean);
  ``quorum``     the F >= N/2 quorum-starvation cliff on delivery='all'.

The platform is ``"cpu"`` / ``"cpu"`` on the CPU, so a CPU capture
compares with the committed ``ATLAS_BASELINE.json`` (a JAX CPU capture),
and ``"gpu"`` / the card's name on the card, which the gate then calls
incomparable with a CPU baseline.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from . import gate, search
from .scenario import parse_axis

#: The committed artifact's record tag.
ATLAS_MANIFEST_KIND = "atlas_manifest"

SCHEMA_VERSION = gate.SCHEMA_VERSION


def _base_cfg(**kw):
    from ..config import SimConfig
    return SimConfig(**kw)


def _ones(trials: int, n: int) -> np.ndarray:
    return np.ones((trials, n), np.int8)


def _search_specs(scale: float = 1.0) -> Dict[str, Dict]:
    """The shipped search registry.  ``scale`` multiplies trials only —
    cliff LOCATIONS are (N, F, p, rounds) physics, so the baseline's
    CPU-smoke trial counts keep the same atlas a full capture refines.
    """
    t = max(1, int(round(8 * scale)))
    tq = max(1, int(round(4 * scale)))
    return {
        "omission": {
            "cfg": dict(n_nodes=64, n_faulty=16, trials=t,
                        max_rounds=16, delivery="all", path="histogram",
                        seed=0),
            "axis": "drop_prob:0.02:0.42:0.02",
            "coarse": 4, "inputs": None,
        },
        "partition": {
            "cfg": dict(n_nodes=64, n_faulty=16, trials=t,
                        max_rounds=12, seed=0),
            "axis": "heal_round:2:18:1",
            "coarse": 4, "inputs": "ones",
        },
        "quorum": {
            "cfg": dict(n_nodes=16, n_faulty=1, trials=tq,
                        max_rounds=8, delivery="all", seed=0),
            "axis": "f:1:12:1",
            "coarse": 4, "inputs": "ones",
        },
    }


def capture_atlas(searches: Sequence[str] = ("omission", "partition",
                                             "quorum"),
                  scale: float = 1.0, forensics: bool = True,
                  journal_path: Optional[str] = None,
                  resume: bool = False, out_dir: Optional[str] = None,
                  verbose: bool = False, device=None) -> Dict:
    """Run the named searches and build the manifest document.

    All searches share one journal (``journal_path``): the evaluator
    truncates it exactly once (first search, unless resuming), then
    every generation of every search appends with resume semantics, so
    a SIGKILL'd capture restarted with ``resume=True`` replays the
    completed prefix from the journal bit-identically (0 compiles) and
    executes only the remainder.
    """
    specs = _search_specs(scale)
    unknown = [s for s in searches if s not in specs]
    if unknown:
        raise ValueError(f"unknown atlas search(es) {unknown}; "
                         f"shipped searches: {sorted(specs)}")
    docs, first = [], True
    for name in searches:
        spec = specs[name]
        cfg = _base_cfg(**spec["cfg"])
        iv = (_ones(cfg.trials, cfg.n_nodes)
              if spec["inputs"] == "ones" else None)
        if verbose:
            print(f"atlas search [{name}]: {spec['axis']} over "
                  f"N={cfg.n_nodes} F={cfg.n_faulty} T={cfg.trials} "
                  f"R={cfg.max_rounds}", flush=True)
        res = search.find_cliffs(
            cfg, spec["axis"], coarse=spec["coarse"],
            initial_values=iv, journal_path=journal_path,
            resume=resume or not first, forensics=forensics,
            out_dir=out_dir, verbose=verbose, device=device)
        first = False
        doc = res.to_dict()
        doc["name"] = name
        docs.append(doc)
    return build_manifest(docs, scale=scale, device=device)


def build_manifest(search_docs: Sequence[Dict], scale: float = 1.0,
                   device=None) -> Dict:
    from ..sim import device_identity
    platform, kind = device_identity(device)
    return {
        "kind": ATLAS_MANIFEST_KIND,
        "schema_version": SCHEMA_VERSION,
        "platform": platform,
        "device_kind": kind,
        "scale": {"factor": float(scale)},
        "searches": list(search_docs),
        "probe_count": sum(int(s["probe_count"]) for s in search_docs),
        "compile_count": sum(int(s["compile_count"])
                             for s in search_docs),
        "cliff_count": sum(len(s["cliffs"]) for s in search_docs),
    }


def save_manifest(path: str, doc: Dict) -> None:
    from ..utils import metrics
    metrics._atomic_write(path, json.dumps(doc, indent=1,
                                           sort_keys=True) + "\n")


def load_manifest(path: str) -> Dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != ATLAS_MANIFEST_KIND:
        raise ValueError(f"{path}: not an atlas manifest "
                         f"(kind={doc.get('kind')!r})")
    return doc


def journal_parity(doc: Dict, journal_path: str) -> Dict:
    """Probe-count/journal parity: the manifest's probe totals must
    equal the ``atlas_probe`` records the journal holds."""
    from . import PROBE_KIND
    n = 0
    with open(journal_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue              # torn tail — the tail contract
            if rec.get("kind") == PROBE_KIND:
                n += 1
    return {"journal_probes": n,
            "manifest_probes": int(doc.get("probe_count", -1)),
            "parity": n == int(doc.get("probe_count", -1))}


def _axis_of(search_doc: Dict):
    return parse_axis(search_doc["spec"])
