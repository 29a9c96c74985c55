"""Bucket-lifecycle spans of the batched sweep engine (port of
benor_tpu/sweepscope/spans.py).

Every bucket of ``sweep.run_points_batched`` emits one whole-bucket span
with four stage children (prepare -> compile, the build leg's
kernel-library load -> execute -> fetch) and a flow arrow from the bucket
span to each point it carried (one thin span a point on the
``sweep.points`` track, over the bucket's execute window).  A bucket
restored from the journal emits one ``restore`` stage instead.  ``python
-m benor_tpu_torch sweep --batched --trace-out`` arms it.

Tracing is off by default (``SPANS.add`` is a no-op) and reads only the
``perf_counter`` stamps the engine takes anyway for its stage clocks, so
tracing on and off give the same results and ``library_events``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils.metrics import SPANS, perf_to_epoch

#: Stage names in lifecycle order, as emitted on the bucket track.
STAGE_NAMES = ("prepare", "compile", "execute", "fetch")


def emit_bucket_spans(bucket_index: int, kind: str,
                      point_indices: List[int], cfgs,
                      stamps: Dict[str, Tuple[float, float]],
                      reused: bool = False) -> Optional[int]:
    """Emit one bucket's span tree into the process-wide SPANS log.

    ``stamps`` maps stage name -> (perf_counter start, duration s); a
    journal-restored bucket passes a single ``restore`` stamp.  Returns
    the bucket span id (None when tracing is off)."""
    if not SPANS.enabled:
        return None
    order = ("restore",) if reused else STAGE_NAMES
    present = [s for s in order if s in stamps]
    if not present:
        return None
    start = min(stamps[s][0] for s in present)
    end = max(stamps[s][0] + stamps[s][1] for s in present)
    flows = [SPANS.new_flow() for _ in point_indices]
    bucket_id = SPANS.add(
        f"sweep.bucket[{bucket_index}]", perf_to_epoch(start),
        end - start, track="sweep.buckets", flow_out=flows,
        args={"bucket": int(bucket_index), "kind": kind,
              "size": len(point_indices), "reused": bool(reused),
              "points": [int(i) for i in point_indices]})
    for stage in present:
        t0, dur = stamps[stage]
        SPANS.add(f"sweep.{stage}", perf_to_epoch(t0), dur,
                  track="sweep.buckets", parent_id=bucket_id,
                  args={"bucket": int(bucket_index)})
    # each point's summary was computed in the execute window; restored
    # buckets anchor their points on the restore
    ex_start, ex_dur = stamps.get("execute", stamps[present[0]])
    for fid, idx, cfg in zip(flows, point_indices, cfgs):
        SPANS.add(f"sweep.point[{int(idx)}]", perf_to_epoch(ex_start),
                  ex_dur, track="sweep.points", flow_in=fid,
                  args={"point": int(idx), "bucket": int(bucket_index),
                        "n_faulty": int(cfg.n_faulty)})
    return bucket_id
