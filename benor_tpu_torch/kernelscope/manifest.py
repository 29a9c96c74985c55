"""The ``kind: kernel_manifest`` document (port of
benor_tpu/kernelscope/manifest.py, stdlib only): emitted by ``python -m
benor_tpu_torch profile --kernels`` and compared against the committed
``KERNEL_BASELINE.json`` by gate.py.  The capture hands plain dicts in."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

#: The manifest's ``kind`` tag.
KERNEL_MANIFEST_KIND = "kernel_manifest"

SCHEMA_VERSION = 1


def build_kernel_manifest(kernels: Dict[str, dict], scale: dict,
                          platform: str, device_kind: str,
                          interpret: bool,
                          telem_columns: List[str],
                          fused_vs_xla: Optional[dict] = None,
                          torch_version: Optional[str] = None) -> dict:
    """The manifest of per-kernel capture blobs (capture.capture_kernels
    builds them).  ``torch_version`` marks a document of the port."""
    doc = {
        "kind": KERNEL_MANIFEST_KIND,
        "schema_version": SCHEMA_VERSION,
        "platform": platform,
        "device_kind": device_kind,
        "interpret": bool(interpret),
        "scale": dict(scale),
        "telem_columns": list(telem_columns),
        "kernels": kernels,
        "fused_vs_xla": fused_vs_xla,
    }
    if torch_version is not None:
        doc["torch_version"] = torch_version
    return doc


def save_kernel_manifest(path: str, manifest: dict) -> None:
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)


def load_kernel_manifest(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != KERNEL_MANIFEST_KIND:
        raise ValueError(
            f"{path}: kind={doc.get('kind')!r} is not a kernel manifest")
    return doc
