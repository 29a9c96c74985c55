"""Telemetry-accumulator assembly: raw counters -> attribution rows (port
of benor_tpu/kernelscope/report.py, numpy only).

The round kernels hand back one int32 ``[stages, tiles, TELEM_WIDTH]``
accumulator a run (``run_consensus`` under ``SimConfig.kernel_telemetry``,
ops/packed_round.py ``TELEM_COLUMNS``), summed over rounds and trials with
the tile and stage kept.  This module turns it into the manifest's
``stages`` blocks and the derived ratios, and owns the JSON-lines record
kind of live kernel-telemetry records.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

#: JSON-lines record kind for live kernel-telemetry records
#: (metrics.append_jsonl producers; the JAX package's `watch` renders
#: them, interleaved with heartbeats and sweep-journal records).
KERNEL_TELEM_KIND = "kernel_telemetry"


def stage_report(telem, columns: Sequence[str],
                 stages: Sequence[str] = ("proposal", "vote")
                 ) -> Dict[str, dict]:
    """Accumulator int32 [stages, tiles, W] -> per-stage blocks:

      ``counters``  column name -> total over every tile
      ``per_tile``  tiles x W nested lists (the tile-level attribution
                    — a straggling or pad-dominated tile is visible, not
                    averaged away)
    """
    a = np.asarray(telem, dtype=np.int64)
    if a.ndim != 3 or a.shape[0] != len(stages) or \
            a.shape[2] != len(columns):
        raise ValueError(
            f"telemetry accumulator shape {a.shape} does not match "
            f"{len(stages)} stages x tiles x {len(columns)} columns")
    out = {}
    for i, stage in enumerate(stages):
        totals = a[i].sum(axis=0)
        out[stage] = {
            "counters": {c: int(totals[j]) for j, c in enumerate(columns)},
            "per_tile": [[int(v) for v in row] for row in a[i]],
        }
    return out


def pad_waste_frac(stage_blocks: Dict[str, dict]) -> Optional[float]:
    """Fraction of all lane-slots the kernels ran for PADDING — the
    relayout/re-tiling target number.  Computed from the proposal
    stage's counters (both stages see the identical lane split; using
    one keeps the recomputation in the manifest checker unambiguous).
    None when the accumulator never saw a lane (zero executed rounds).
    """
    c = stage_blocks["proposal"]["counters"]
    active, pad = c["active_lanes"], c["pad_lanes"]
    if active + pad == 0:
        return None
    return round(pad / (active + pad), 6)


def plane_hops_per_round(stage_blocks: Dict[str, dict], trials: int,
                         rounds: int) -> Optional[float]:
    """Plane-stack HBM round trips per protocol round, recovered from
    the hop counters: each tile emits its stage's static hop count once
    per trial per round, so the counter total is
    hops x tiles x trials x rounds and the per-round figure divides it
    back out — 2.0 on the single-pass kernel, 3.0 on the two-kernel
    pipeline, MEASURED from inside the kernels rather than assumed from
    the dispatch."""
    if trials <= 0 or rounds <= 0:
        return None
    total = 0.0
    for blk in stage_blocks.values():
        tiles = len(blk["per_tile"])
        if tiles == 0:
            return None
        total += blk["counters"]["plane_hops"] / (tiles * trials * rounds)
    return round(total, 6)


def telemetry_record(label: str, kernel: str, stage_blocks: Dict[str, dict],
                     rounds: int, waste: Optional[float]) -> dict:
    """One ``kind: kernel_telemetry`` JSON-lines record for the live
    watch plane (metrics.append_jsonl): stage totals only — compact
    enough to tail, the per-tile detail stays in the manifest."""
    return {
        "kind": KERNEL_TELEM_KIND,
        "label": label,
        "kernel": kernel,
        "rounds": int(rounds),
        "pad_waste_frac": waste,
        "stage_totals": {s: dict(b["counters"])
                         for s, b in stage_blocks.items()},
    }
