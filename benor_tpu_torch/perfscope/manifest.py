"""The perf manifest: the JSON document a profile run emits (port of
benor_tpu/perfscope/manifest.py).

One manifest is one profile run: the device, the profile scale and one
PerfReport a regime, in the JAX package's format, with ``torch_version``
in place of ``jax_version`` and ``unported_regimes`` naming the regimes
the port does not capture yet and their ROADMAP item.  ``python -m
benor_tpu_torch profile`` compares it against the committed
``PERF_BASELINE.json`` (baseline.py).
"""

from __future__ import annotations

import json
import time
from typing import List, Sequence

from .capture import REPORT_VERSION, PerfReport
from .regimes import REGIME_NAMES, UNPORTED_REGIMES

#: The manifest's ``kind`` tag.
MANIFEST_KIND = "perf_manifest"


def build_manifest(reports: Sequence[PerfReport], scale: dict,
                   fused_vs_xla: dict = None, device=None) -> dict:
    """The manifest document of a profile run's reports.
    ``fused_vs_xla`` (regimes.capture_fused_vs_xla) None records an
    explicit null (a ``--regimes`` subset skipped the pair)."""
    import torch

    from ..sim import device_identity

    platform, kind = device_identity(device)
    return {
        "kind": MANIFEST_KIND,
        "schema_version": REPORT_VERSION,
        "platform": platform,
        "device_kind": kind,
        "torch_version": torch.__version__,
        "created_unix": round(time.time(), 3),
        "scale": {k: int(scale[k])
                  for k in ("n_nodes", "trials", "max_rounds", "seed")},
        "regimes": {r.regime: r.to_dict() for r in reports},
        "unported_regimes": {r: f"ROADMAP Queue A item {item}"
                             for r, item in UNPORTED_REGIMES.items()},
        "fused_vs_xla": fused_vs_xla,
    }


def missing_regimes(manifest: dict) -> List[str]:
    """Regime keys a complete manifest carries but this one lacks (a
    regime the manifest names unported is not missing)."""
    skip = manifest.get("unported_regimes") or {}
    return [r for r in REGIME_NAMES
            if r not in manifest.get("regimes", {}) and r not in skip]


def save_manifest(path: str, manifest: dict) -> None:
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")


def load_manifest(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != MANIFEST_KIND:
        raise ValueError(
            f"{path}: not a perf manifest (kind={doc.get('kind')!r})")
    return doc
