"""The faultlab proof document, ``kind: faults_manifest`` (port of
benor_tpu/faults/report.py): the injection-off identity, the omission
curve's one-bucket claim and clean audits across the fault families, with
its ``ok`` verdict derived from the parts.  The JAX package's schema
checker (tools/check_metrics_schema.check_faults_manifest) reads the same
document.
"""

from __future__ import annotations

from typing import Dict

#: The manifest kind.
FAULTS_KIND = "faults_manifest"


def faults_manifest(identity: Dict, curves: Dict, audits: Dict) -> Dict:
    """Assemble the document from its measured parts.

    ``identity``: {'bit_equal': bool, 'extra_compiles': int}, the
    injection-off rerun against the plain config; ``curves``: the
    results.faults_curves dict; ``audits``: label -> {'ok', 'checks',
    'violations'} per audited fault family.  ``ok`` is derived here, so a
    hand-edited verdict cannot survive a recompute.  The one-bucket claim
    is read from ``drop_buckets``: the JAX package reads it from the
    curve's executable count, 1 exactly when the curve is one bucket,
    where the port's ``drop_compile_count`` counts kernel-library builds
    and loads (0 on the CPU and in a warm process)."""
    ok = (bool(identity.get("bit_equal"))
          and identity.get("extra_compiles") == 0
          and len(curves.get("drop_curve", [])) > 0
          and len(curves.get("churn_curve", [])) > 0
          and curves.get("drop_buckets") == 1
          and all(bool(a.get("ok")) for a in audits.values())
          and len(audits) > 0)
    return {
        "kind": FAULTS_KIND,
        "ok": bool(ok),
        "off_identity": dict(identity),
        **{k: curves[k] for k in ("drop_curve", "drop_compile_count",
                                  "drop_buckets", "churn_curve",
                                  "churn_compile_count")},
        "audits": {k: dict(v) for k, v in audits.items()},
    }
