"""The ``kind: sweep_manifest`` document (port of
benor_tpu/sweepscope/manifest.py).

Reduces one ``sweep.BatchedCurve`` (its per-bucket stage clocks) to the
document the sweep gate reads: per-bucket prepare / compile / run / fetch
clocks, their totals, the strictly serial wall, the ideal-pipeline bound
and the overlap headroom (gate.py owns the model), the pipeline block, and
the telescoping check that the stage clocks account for the sweep's wall.
In the port a bucket's ``compile_s`` is its build leg's kernel-library
load and ``compile_count`` the library's builds and loads (0 warm and on
the CPU).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

from . import gate

#: The manifest's ``kind`` tag.
SWEEP_MANIFEST_KIND = "sweep_manifest"

SCHEMA_VERSION = gate.SCHEMA_VERSION


def default_sweep_scale() -> Dict:
    """The fixed capture scale of the committed SWEEP_BASELINE.json: the
    smallest geometry whose f grid gives both bucket kinds — three CF
    points sharing one dynamic bucket (quorum > sampling.EXACT_TABLE_MAX)
    and one exact-table point in a static bucket of its own."""
    return {"n_nodes": 9000, "trials": 4, "max_rounds": 12, "seed": 0}


def capture_f_values(n_nodes: int) -> list:
    """The standard capture's f grid at ``n_nodes``: three dynamic-bucket
    points and one quorum-specialized (exact-table) point."""
    from ..ops import sampling
    if n_nodes <= sampling.EXACT_TABLE_MAX:
        raise ValueError(
            f"the sweep capture needs n_nodes > "
            f"{sampling.EXACT_TABLE_MAX} so its CF points share a dyn "
            f"bucket (got {n_nodes})")
    dyn = [n_nodes // 15, n_nodes // 7, n_nodes // 5]
    static = [n_nodes - sampling.EXACT_TABLE_MAX + max(1, n_nodes // 18)]
    return dyn + static


def build_sweep_manifest(cb, base_cfg, platform: Optional[str] = None,
                         device_kind: Optional[str] = None,
                         device=None) -> Dict:
    """A ``BatchedCurve`` and its base config -> the manifest document;
    ``platform`` / ``device_kind`` default to ``device``'s
    (``sim.device_identity``).

    Refuses a resumed curve: a journal-restored bucket's stage clocks
    price the original run, so they cannot telescope with this run's
    wall."""
    if any(cb.bucket_reused):
        raise ValueError(
            "cannot build a sweep manifest from a resumed curve "
            f"({sum(cb.bucket_reused)} of {cb.n_buckets} buckets were "
            "journal-restored): the stage clocks price the original "
            "run, not this wall clock — capture an uninterrupted run")
    if platform is None or device_kind is None:
        from ..sim import device_identity
        plat, kind = device_identity(device)
        platform = plat if platform is None else platform
        device_kind = kind if device_kind is None else device_kind
    buckets = []
    for i in range(cb.n_buckets):
        buckets.append({
            "index": i,
            "kind": cb.bucket_kinds[i],
            "size": cb.bucket_sizes[i],
            "point_indices": [int(p) for p in cb.bucket_point_indices[i]],
            "prepare_s": round(cb.bucket_prepare_s[i], 6),
            "compile_s": round(cb.bucket_compile_s[i], 6),
            "run_s": round(cb.bucket_run_s[i], 6),
            "fetch_s": round(cb.bucket_fetch_s[i], 6),
            "compile_count": int(cb.bucket_compile_counts[i]),
        })
    totals = {s: round(sum(float(b[s]) for b in buckets), 6)
              for s in gate.STAGES}
    serial = round(gate.serial_s(buckets), 6)
    ideal = round(gate.ideal_pipeline_s(buckets), 6)
    headroom = round(max(0.0, serial - ideal), 6)
    wall = round(float(cb.wall_s), 6)
    coverage = round(serial / wall, 6) if wall > 0 else 0.0
    span = round(float(cb.span_s), 6)
    reclaimed = round(gate.headroom_reclaimed_s(buckets, span), 6)
    pipeline = {
        "pipelined": bool(cb.pipelined),
        "span_s": span,
        "headroom_model_s": headroom,
        "headroom_reclaimed_s": reclaimed,
        "headroom_reclaimed_frac": (round(reclaimed / headroom, 6)
                                    if headroom > 0 else 0.0),
    }
    return {
        "kind": SWEEP_MANIFEST_KIND,
        "schema_version": SCHEMA_VERSION,
        "platform": platform,
        "device_kind": device_kind,
        "scale": {
            "n_nodes": int(base_cfg.n_nodes),
            "trials": int(base_cfg.trials),
            "max_rounds": int(base_cfg.max_rounds),
            "seed": int(base_cfg.seed),
            "n_points": len(cb.points),
            "f_values": [int(p.n_faulty) for p in cb.points],
        },
        "n_buckets": int(cb.n_buckets),
        "compile_count": int(cb.compile_count),
        "wall_s": wall,
        "buckets": buckets,
        "stage_totals": totals,
        "serial_s": serial,
        "ideal_pipeline_s": ideal,
        "overlap_headroom_s": headroom,
        "overlap_headroom_frac": (round(headroom / serial, 6)
                                  if serial > 0 else 0.0),
        "pipeline": pipeline,
        "telescoping": {
            "stage_sum_s": serial,
            "wall_s": wall,
            "coverage": coverage,
        },
    }


def capture_base_config(f_values: Optional[Sequence[int]] = None,
                        **scale):
    """The standard capture workload -> (base SimConfig, f grid)."""
    from ..config import SimConfig

    sc = default_sweep_scale()
    sc.update(scale)
    fs = (capture_f_values(sc["n_nodes"]) if f_values is None
          else list(f_values))
    base = SimConfig(n_nodes=sc["n_nodes"], n_faulty=0,
                     trials=sc["trials"], max_rounds=sc["max_rounds"],
                     seed=sc["seed"], delivery="quorum",
                     scheduler="uniform", path="histogram")
    return base, fs


def capture_sweep_manifest(journal_path: Optional[str] = None,
                           f_values: Optional[Sequence[int]] = None,
                           pipeline: bool = False, device=None, **scale):
    """Run the standard two-bucket capture curve and build its manifest
    -> (manifest, BatchedCurve).  ``pipeline=True`` captures the
    build-ahead scheduler (the committed baseline's mode)."""
    from ..sweep import run_curve_batched

    base, fs = capture_base_config(f_values=f_values, **scale)
    cb = run_curve_batched(base, fs, journal_path=journal_path,
                           pipeline=pipeline, device=device)
    return build_sweep_manifest(cb, base, device=device), cb


def save_sweep_manifest(path: str, manifest: Dict) -> None:
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1)


def load_sweep_manifest(path: str) -> Dict:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != SWEEP_MANIFEST_KIND:
        raise ValueError(
            f"{path}: not a sweep manifest (kind={doc.get('kind')!r})")
    return doc
