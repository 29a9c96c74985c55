"""Cliff-drift gate: compare two atlas manifests, stdlib-only (port of
benor_tpu/atlas/gate.py).

What regresses (findings):

  * a baseline cliff VANISHES — the fresh capture's matching search has
    no cliff on that axis anywhere near it;
  * a baseline cliff MOVES outside its bracket band — the fresh point
    estimate leaves ``[lo - band*width, hi + band*width]`` of the
    committed bracketing interval (band :data:`CLIFF_BAND`);
  * a committed repro STOPS REPRODUCING — the fresh capture replayed
    the cliff's minimal repro and its verdict came back different
    (``repro_reproduced: false``), or a repro document's digest no
    longer matches its canonical payload;
  * a whole baseline search has no counterpart in the fresh manifest.

What does NOT regress: extra cliffs or searches in the fresh manifest,
probe-count and compile-count changes.

Incomparable (``IncomparableAtlas``): a platform, device kind or scale
mismatch — a CPU baseline says nothing about the cliffs a GPU capture
finds.  The digest and the comparison are the JAX package's, so the two
packages' manifests and repros are checked alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional

#: Manifest schema version — bumped with any shape change; part of the
#: comparability check so an old-shape baseline is incomparable, not
#: misread.
SCHEMA_VERSION = 1

#: Allowed point-estimate drift, in units of the BASELINE bracket
#: width, beyond each bracket end: the fresh estimate must land inside
#: ``[lo - band*width, hi + band*width]``.  1.0 tolerates one full
#: bracket of sampling wobble; a cliff that moved further has changed
#: regime.
CLIFF_BAND = 1.0

#: The repro-digest payload fields, in canonical order.  The digest is
#: sha256 over the sorted-key JSON of exactly these fields — shared
#: verbatim by atlas/repro.py (emission), this gate and
#: check_metrics_schema.check_atlas_manifest (recompute-don't-trust).
REPRO_DIGEST_FIELDS = ("config", "faults", "inputs", "label", "verdict")


def repro_digest(doc: Dict) -> str:
    """The canonical digest of one ``kind: atlas_repro`` document."""
    payload = {k: doc.get(k) for k in REPRO_DIGEST_FIELDS}
    return "sha256:" + hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


class IncomparableAtlas(Exception):
    """Baseline and manifest describe different machines/scales — the
    gate must refuse (exit 3), not vacuously pass."""


@dataclasses.dataclass
class AtlasFinding:
    """One gate regression: which cliff, what drifted."""

    metric: str
    message: str

    def to_dict(self) -> Dict:
        return {"metric": self.metric, "message": self.message}


def _require(doc: Dict, name: str) -> None:
    if doc.get("kind") != "atlas_manifest":
        raise IncomparableAtlas(
            f"{name} is not an atlas manifest (kind="
            f"{doc.get('kind')!r})")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise IncomparableAtlas(
            f"{name} schema_version {doc.get('schema_version')!r} != "
            f"{SCHEMA_VERSION} (recapture, do not hand-edit)")


def _search_key(search: Dict) -> str:
    return str(search.get("spec"))


def _nearest_cliff(cliffs: List[Dict], point: float) -> Optional[Dict]:
    best, best_d = None, None
    for c in cliffs:
        try:
            d = abs(float(c["point"]) - point)
        except (KeyError, TypeError, ValueError):
            continue
        if best_d is None or d < best_d:
            best, best_d = c, d
    return best


def compare_atlas(manifest: Dict, baseline: Dict,
                  band: float = CLIFF_BAND) -> List[AtlasFinding]:
    """Findings list (empty = in-band) or IncomparableAtlas."""
    _require(manifest, "manifest")
    _require(baseline, "baseline")
    for field in ("platform", "device_kind"):
        if manifest.get(field) != baseline.get(field):
            raise IncomparableAtlas(
                f"{field} mismatch: manifest "
                f"{manifest.get(field)!r} vs baseline "
                f"{baseline.get(field)!r} — cliff locations are "
                f"machine-conditioned; recapture the baseline instead")
    if manifest.get("scale") != baseline.get("scale"):
        raise IncomparableAtlas(
            f"scale mismatch: manifest {manifest.get('scale')!r} vs "
            f"baseline {baseline.get('scale')!r} — cliffs move with "
            f"(N, trials, rounds); recapture the baseline instead")

    findings: List[AtlasFinding] = []
    fresh = {_search_key(s): s for s in manifest.get("searches", [])}
    for bs in baseline.get("searches", []):
        key = _search_key(bs)
        ms = fresh.get(key)
        if ms is None:
            findings.append(AtlasFinding(
                f"search[{key}]",
                f"baseline search {key!r} has no counterpart in the "
                f"fresh manifest — its cliffs are unverifiable"))
            continue
        mcliffs = ms.get("cliffs", [])
        for bc in bs.get("cliffs", []):
            lo, hi = float(bc["lo"]), float(bc["hi"])
            width = max(hi - lo, 1e-12)
            label = f"cliff[{key} @ {bc.get('point')}]"
            mc = _nearest_cliff(mcliffs, float(bc["point"]))
            in_band = (mc is not None and
                       lo - band * width <= float(mc["point"])
                       <= hi + band * width)
            if mc is None or not in_band:
                where = ("no cliff found at all" if mc is None else
                         f"nearest fresh point estimate {mc['point']} "
                         f"is outside [{lo - band * width:.6g}, "
                         f"{hi + band * width:.6g}]")
                verb = "vanished" if mc is None else "moved"
                findings.append(AtlasFinding(
                    label,
                    f"baseline cliff at {bc['point']} (bracket "
                    f"[{lo}, {hi}]) {verb}: {where}"))
                continue
            # the matched fresh cliff must still reproduce its repro
            if mc.get("repro") is not None:
                if repro_digest(mc["repro"]) != mc["repro"].get("digest"):
                    findings.append(AtlasFinding(
                        label,
                        "fresh cliff's repro digest does not match its "
                        "canonical payload — the repro was edited or "
                        "the emitter drifted"))
                if mc.get("repro_reproduced") is False:
                    findings.append(AtlasFinding(
                        label,
                        "the cliff's minimal repro no longer reproduces "
                        "its recorded verdict — the committed evidence "
                        "is stale"))
            elif bc.get("repro") is not None:
                findings.append(AtlasFinding(
                    label,
                    "baseline cliff carries a repro but the fresh "
                    "capture emitted none — forensics regressed"))
    return findings
