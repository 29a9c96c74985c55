"""The durable sweep journal: append-only bucket records and exact resume
(port of benor_tpu/sweepscope/journal.py:60-282).

After each bucket of ``sweep.run_points_batched`` completes, one JSON line
(``kind: sweep_bucket``, appended line-atomically) records what is needed
to reassemble that bucket's points without running it: its position, kind
and point indices; an input fingerprint (sha256 over every point config,
the initial values and the fault masks); the stage clocks and the
bucket's compile count; and the per-point summaries, serialised value for
value.  ``run_points_batched(..., journal_path=..., resume=True)`` skips
every bucket whose fingerprint and point indices match a record and
rebuilds its points through ``sweep.point_from_raw``.  A mismatch of any
kind — another input, a torn last line, edited indices, an edited payload
(every record carries a digest of its payloads), an edited provenance
field (an integrity stamp covers them) — reruns the bucket.

The record format, the fingerprint and the digests are the JAX
package's, byte for byte: a journal written by either package resumes in
the other.  Each bucket recorded ticks ``sweepscope.journal.buckets`` and
each tampered record ``sweepscope.journal.tampered`` in the metrics
registry, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics

#: Record tag of one completed bucket.
BUCKET_KIND = "sweep_bucket"

#: Terminal record of a completed sweep.
DONE_KIND = "sweep_done"

#: The record-shape version; part of the fingerprint, so a journal of
#: another version reruns rather than misparses.
JOURNAL_VERSION = 2


def _hash_array(h, arr) -> None:
    """Shape, dtype and bytes of a host array; a tensor is copied to the
    host first, so a mask hashes alike on every device and in both
    packages."""
    if hasattr(arr, "cpu"):
        arr = arr.cpu().numpy()
    a = np.asarray(arr)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())


def bucket_fingerprint(cfgs, initial_values, faults) -> str:
    """Input fingerprint of one bucket: every point config (canonical
    sorted-key JSON; the seed rides inside), the shared initial values and
    each point's fault masks (faulty, crash_round, and recover_round where
    the crash-recover plane is armed)."""
    h = hashlib.sha256()
    h.update(f"sweep-journal-v{JOURNAL_VERSION}".encode())
    for c in cfgs:
        h.update(json.dumps(dataclasses.asdict(c), sort_keys=True,
                            default=str).encode())
    _hash_array(h, initial_values)
    for fl in faults:
        _hash_array(h, fl.faulty)
        _hash_array(h, fl.crash_round)
        if fl.recover_round is not None:
            _hash_array(h, fl.recover_round)
    return "sha256:" + h.hexdigest()


def serialize_point(cfg_f, vals) -> dict:
    """One point's raw outputs -> a JSON-exact payload.  ``vals`` is the
    layout ``sweep.point_from_raw`` takes: (rounds, decided, mean_k, ones,
    k_hist, disagree[, recorder][, witness]); the scalars are the float32
    summaries as Python floats, which JSON keeps exactly."""
    r, dec, mk, ones, khist, dis, *rest = vals
    rest = list(rest)
    d = {
        "rounds": int(r),
        "decided": float(dec),
        "mean_k": float(mk),
        "ones": float(ones),
        "k_hist": np.asarray(khist).astype(np.int64).tolist(),
        "disagree": float(dis),
    }
    if cfg_f.record:
        d["round_history"] = np.asarray(rest.pop(0), np.int32).tolist()
    if cfg_f.witness:
        d["witness"] = np.asarray(rest.pop(0), np.int32).tolist()
    return d


def deserialize_point(cfg_f, payload: dict) -> list:
    """A journal payload -> the raw ``vals`` list ``sweep.point_from_raw``
    takes (the inverse of :func:`serialize_point`)."""
    vals = [payload["rounds"], payload["decided"], payload["mean_k"],
            payload["ones"], np.asarray(payload["k_hist"], np.int64),
            payload["disagree"]]
    if cfg_f.record:
        vals.append(np.asarray(payload["round_history"], np.int32))
    if cfg_f.witness:
        vals.append(np.asarray(payload["witness"], np.int32))
    return vals


def payload_digest(points: List[dict]) -> str:
    """Digest of a record's payload list (canonical JSON), recomputed at
    resume: a payload edited in place reruns its bucket."""
    return "sha256:" + hashlib.sha256(
        json.dumps(points, sort_keys=True).encode()).hexdigest()


def record_stamp(fingerprint: str, point_indices: List[int],
                 mesh_shape, pipelined: bool,
                 payload_sha256: str) -> str:
    """Integrity stamp over a record's identity fields: fingerprint, point
    indices, mesh shape, pipelined flag and payload digest.  The mesh and
    pipeline fields are provenance, not part of the lookup, but an edit to
    them breaks the stamp and the bucket reruns."""
    blob = json.dumps({
        "fingerprint": fingerprint,
        "point_indices": [int(i) for i in point_indices],
        "mesh_shape": (None if mesh_shape is None
                       else [int(s) for s in mesh_shape]),
        "pipelined": bool(pipelined),
        "payload_sha256": payload_sha256,
    }, sort_keys=True)
    return "sha256:" + hashlib.sha256(blob.encode()).hexdigest()


def read_journal(path: str) -> List[dict]:
    """A journal file's bucket and done records, in file order.  A torn or
    mangled line is skipped: its bucket has no record and reruns."""
    out: List[dict] = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue                  # torn or edited line: no record
        if isinstance(rec, dict) and rec.get("kind") in (BUCKET_KIND,
                                                         DONE_KIND):
            out.append(rec)
    return out


class SweepJournal:
    """One run's journal: the write side appends bucket and done records;
    the resume side indexes the file's records by (fingerprint, point
    indices), the latest record winning, so a drift in either misses and
    the bucket reruns.  A run that does not resume truncates the file."""

    def __init__(self, path: str, resume: bool = False,
                 label: str = "sweep"):
        self.path = path
        self.label = label
        self.reused = 0
        self._lookup: Dict[Tuple[str, Tuple[int, ...]], dict] = {}
        if resume:
            for rec in read_journal(path):
                if rec.get("kind") != BUCKET_KIND:
                    continue
                fp = rec.get("fingerprint")
                idx = rec.get("point_indices")
                if isinstance(fp, str) and isinstance(idx, list):
                    self._lookup[(fp, tuple(int(i) for i in idx))] = rec
        else:
            with open(path, "w"):
                pass

    def match(self, fingerprint: str,
              point_indices: List[int]) -> Optional[dict]:
        """The completed-bucket record for these inputs, or None; a record
        whose payload count, digest or stamp does not check out is never
        reused."""
        rec = self._lookup.get((fingerprint, tuple(point_indices)))
        if rec is None:
            return None
        pts = rec.get("points")
        if (not isinstance(pts, list)
                or len(pts) != len(point_indices)
                or rec.get("payload_sha256") != payload_digest(pts)
                or rec.get("stamp_sha256") != record_stamp(
                    fingerprint, list(point_indices),
                    rec.get("mesh_shape"), rec.get("pipelined", False),
                    rec.get("payload_sha256"))):
            metrics.REGISTRY.counter("sweepscope.journal.tampered").inc()
            return None
        return rec

    def record_bucket(self, index: int, kind: str,
                      point_indices: List[int], fingerprint: str,
                      compile_count: int, stages: Dict[str, float],
                      points: List[dict], mesh_shape=None,
                      pipelined: bool = False) -> dict:
        digest = payload_digest(points)
        idx = [int(i) for i in point_indices]
        shape = (None if mesh_shape is None
                 else [int(s) for s in mesh_shape])
        rec = {
            "kind": BUCKET_KIND, "label": self.label,
            "journal_version": JOURNAL_VERSION,
            "bucket_index": int(index), "bucket_kind": kind,
            "point_indices": idx,
            "fingerprint": fingerprint,
            "mesh_shape": shape,
            "pipelined": bool(pipelined),
            "compile_count": int(compile_count),
            **{k: round(float(v), 6) for k, v in stages.items()},
            "payload_sha256": digest,
            "stamp_sha256": record_stamp(fingerprint, idx, shape,
                                         pipelined, digest),
            "points": points,
        }
        metrics.append_jsonl(self.path, rec)
        metrics.REGISTRY.counter("sweepscope.journal.buckets").inc()
        return rec

    def record_done(self, points_total: int, n_buckets: int,
                    overlap_headroom_s: float) -> dict:
        rec = {
            "kind": DONE_KIND, "label": self.label, "done": True,
            "points_total": int(points_total),
            "n_buckets": int(n_buckets),
            "buckets_reused": int(self.reused),
            "overlap_headroom_s": round(float(overlap_headroom_s), 6),
        }
        metrics.append_jsonl(self.path, rec)
        return rec
