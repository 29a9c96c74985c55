"""The progress heartbeat: beats from long sliced runs and batched sweeps
(port of benor_tpu/meshscope/heartbeat.py).

Between slices and between buckets, on the host, from what the run already
holds (the flight-recorder rows, the slice round cursor): nothing here runs
inside a round, so heartbeat off and on give the same results bit for bit
and launch the same kernels.

Each beat is published three ways:

  * gauges in utils/metrics.REGISTRY (``heartbeat.round``,
    ``heartbeat.rounds_per_sec``, ``heartbeat.decided_frac``,
    ``heartbeat.eta_s``, ``heartbeat.progress``) and a
    ``heartbeat.published`` counter;
  * one line of an append-only JSON-lines file (metrics.append_jsonl), which
    ``python -m benor_tpu_torch watch`` tails from another process;
  * ``TpuNetwork.get_round_history(since_round=...)``, the cursor feed of
    the recorder's rows.

The cadence is SimConfig.heartbeat_rounds (0 = off): a beat fires whenever
the run's round cursor crosses a multiple of it (``sim.heartbeat_due``).
The batched sweep beats once a bucket instead.  The records equal the JAX
package's field for field but for the clocks (``rounds_per_sec``,
``eta_s``, ``elapsed_s`` and the file's ``ts``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils import metrics

#: Record tag on every heartbeat JSON line (what ``watch`` filters on).
HEARTBEAT_KIND = "heartbeat"


def _decided_frac_from_recorder(recorder) -> Optional[float]:
    """Decided fraction of non-killed lanes, from the LAST written
    flight-recorder row (None when no row was written yet)."""
    from ..state import REC_DECIDED, REC_UNDEC0, REC_UNDEC1, REC_UNDECQ
    rows = metrics.executed_rows(recorder)
    if rows.shape[0] == 0:
        return None
    last = rows[-1]
    undec = last[REC_UNDEC0] + last[REC_UNDEC1] + last[REC_UNDECQ]
    denom = int(last[REC_DECIDED] + undec)
    return float(last[REC_DECIDED] / denom) if denom else None


class HeartbeatPublisher:
    """One run's beats (the rate and the ETA need its history).

    ``path`` (optional) is the append-only JSON-lines file; the registry's
    gauges are fed either way.  The registry and the file append serialise
    on their own locks (utils/metrics.py)."""

    def __init__(self, cfg, path: Optional[str] = None,
                 label: str = "run",
                 registry: Optional[metrics.MetricsRegistry] = None):
        self.cfg = cfg
        self.path = path
        self.label = label
        self.registry = metrics.REGISTRY if registry is None else registry
        self._t0 = time.perf_counter()
        self._last_t = self._t0
        self._last_round = 0

    def publish(self, round_: Optional[int] = None, recorder=None,
                decided_frac: Optional[float] = None,
                progress: Optional[float] = None,
                rate: Optional[float] = None, done: bool = False,
                **extra) -> dict:
        """Emit one beat; returns the record written and registered.

        ``round_`` is the run's round cursor (the rate and the ETA come
        from its motion); ``recorder`` (a flight-recorder buffer, on any
        device) gives the decided fraction when ``decided_frac`` is not
        given; ``progress`` in [0, 1] serves callers whose unit is not
        rounds (the batched sweep passes points done / points total)."""
        now = time.perf_counter()
        rps = rate
        eta = None
        if round_ is not None and rps is None:
            dt = now - self._last_t
            dr = round_ - self._last_round
            if dr > 0 and dt > 0:
                rps = dr / dt
            elif round_ and (now - self._t0) > 0:
                rps = round_ / (now - self._t0)
        if decided_frac is None and recorder is not None:
            decided_frac = _decided_frac_from_recorder(recorder)
        if round_ is not None and rps:
            remaining = max(0, self.cfg.max_rounds - round_)
            if decided_frac is not None and decided_frac >= 1.0:
                remaining = 0
            eta = remaining / rps
        if progress is None and round_ is not None and self.cfg.max_rounds:
            progress = min(1.0, round_ / self.cfg.max_rounds)
        if done:
            eta, progress = 0.0, 1.0
        record = {
            "kind": HEARTBEAT_KIND, "label": self.label,
            "round": (int(round_) if round_ is not None else None),
            "max_rounds": int(self.cfg.max_rounds),
            "rounds_per_sec": (round(float(rps), 4)
                               if rps is not None else None),
            "decided_frac": (round(float(decided_frac), 6)
                             if decided_frac is not None else None),
            "eta_s": round(float(eta), 3) if eta is not None else None,
            "progress": (round(float(progress), 6)
                         if progress is not None else None),
            "elapsed_s": round(now - self._t0, 3),
            "done": bool(done),
        }
        record.update(extra)
        g = self.registry.gauge
        if round_ is not None:
            g("heartbeat.round").set(round_)
            self._last_round = int(round_)
        if rps is not None:
            g("heartbeat.rounds_per_sec").set(rps)
        if decided_frac is not None:
            g("heartbeat.decided_frac").set(decided_frac)
        if eta is not None:
            g("heartbeat.eta_s").set(eta)
        if progress is not None:
            g("heartbeat.progress").set(progress)
        self.registry.counter("heartbeat.published").inc()
        self._last_t = now
        if self.path:
            metrics.append_jsonl(self.path, record)
        return record

    def close(self, round_: Optional[int] = None, recorder=None,
              decided_frac: Optional[float] = None) -> dict:
        """The final beat, ``done: true`` (what ``watch`` stops on)."""
        return self.publish(round_=round_, recorder=recorder,
                            decided_frac=decided_frac, done=True)


# --------------------------------------------------------------------------
# Slice-level publishing: registry gauges only (the file belongs to the
# loop that owns the path, e.g. TpuNetwork.start's poll loop).  Keyed by
# label, so concurrent runs keep their own rate state.
# --------------------------------------------------------------------------

_SLICE_LOCK = threading.Lock()
#: label -> (publisher, round cursor BEFORE the next expected slice); the
#: cursor advances at every boundary, so a fresh run is recognised by a
#: from_round that does not continue where the previous slice stopped.
_SLICE_PUBS: Dict[str, Tuple[HeartbeatPublisher, int]] = {}


def publish_slice_heartbeat(cfg, next_round, recorder=None,
                            label: str = "slice",
                            from_round=None) -> Optional[dict]:
    """Registry-only heartbeat from one slice boundary; returns the record
    when the cadence fired, else None.  ``next_round`` may be a device
    scalar; it is read on the host.  A publisher cached under ``label`` is
    reused only when the slice continues exactly where the previous one
    stopped (``from_round``), so a new run's first rate is its own."""
    from ..sim import heartbeat_due
    r = int(next_round) - 1          # rounds fully executed so far
    prev = None if from_round is None else int(from_round) - 1
    with _SLICE_LOCK:
        pub, seen = _SLICE_PUBS.get(label, (None, 0))
        if (pub is None or pub.cfg != cfg or r < pub._last_round
                or (prev is not None and prev != seen)):
            pub = HeartbeatPublisher(cfg, label=label)
        _SLICE_PUBS[label] = (pub, r)
    if not heartbeat_due(cfg, pub._last_round, r):
        return None
    return pub.publish(round_=r, recorder=recorder)


def publish_sweep_heartbeat(cfg, done: int, total: int,
                            publisher: Optional[HeartbeatPublisher] = None,
                            path: Optional[str] = None,
                            bucket_index: Optional[int] = None) -> dict:
    """One bucket's heartbeat for the batched sweep: progress = points done
    / points total.  Pass a publisher to keep one rate state across
    buckets (the engine does); ``bucket_index`` stamps which bucket just
    completed, so the order of the beats reads from the ``watch`` tail."""
    pub = publisher if publisher is not None else HeartbeatPublisher(
        cfg, path=path, label="sweep")
    extra = {}
    if bucket_index is not None:
        extra["bucket_index"] = int(bucket_index)
    return pub.publish(progress=done / max(total, 1),
                       done=(done >= total),
                       points_done=int(done), points_total=int(total),
                       **extra)


# --------------------------------------------------------------------------
# The reading side: what `python -m benor_tpu_torch watch` runs.
# --------------------------------------------------------------------------


def _parse(line, kinds: Optional[Tuple[str, ...]]) -> Optional[dict]:
    """One JSON line -> its record, None when torn or filtered out.  A
    value that is not a dict with a ``kind`` is wrapped as ``{"kind":
    None, "raw": value}``, so an unknown producer's records surface."""
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict) or "kind" not in rec:
        rec = {"kind": None, "raw": rec}
    if kinds is None or rec.get("kind") in kinds:
        return rec
    return None


def read_records(path: str,
                 kinds: Optional[Tuple[str, ...]] = None) -> List[dict]:
    """Parse a JSON-lines file -> records, in file order.

    The mixed-kind reader behind ``watch``: heartbeats, sweep-journal
    records, kernel telemetry and atlas records interleave freely;
    ``kinds`` filters when given.  A torn line (mid-append, or a killed
    writer's last) is skipped, not an error."""
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rec = _parse(line, kinds)
                if rec is not None:
                    out.append(rec)
    return out


def read_heartbeats(path: str) -> List[dict]:
    """The heartbeat records of a JSON-lines file, in file order."""
    return read_records(path, kinds=(HEARTBEAT_KIND,))


def _read_new_records(path: str, offset: int,
                      kinds: Optional[Tuple[str, ...]]
                      ) -> Tuple[List[dict], int]:
    """Parse only the bytes appended since ``offset`` -> (new records, new
    offset).  The offset advances past complete (newline-ended) lines
    only: a torn tail is read again at the next poll, a complete line that
    does not parse is skipped for good."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        chunk = fh.read()
    nl = chunk.rfind(b"\n")
    if nl < 0:
        return [], offset
    out: List[dict] = []
    for raw in chunk[:nl + 1].splitlines():
        line = raw.strip()
        if line:
            rec = _parse(line.decode("utf-8", errors="replace"), kinds)
            if rec is not None:
                out.append(rec)
    return out, offset + nl + 1


def tail_records(path: str, poll_s: float = 0.2,
                 timeout_s: float = 60.0, follow: bool = True,
                 stop_when_done: bool = True,
                 kinds: Optional[Tuple[str, ...]] = None
                 ) -> Iterator[dict]:
    """Yield records as they are appended (the watch engine).

    Polls ``path`` every ``poll_s`` seconds and yields the new records
    only (read by byte offset, so a journal of large bucket payloads is
    parsed once); stops on a ``done: true`` record of any kind (when
    ``stop_when_done``), when ``follow`` is False and the file has been
    read through once, or after ``timeout_s`` seconds with no new record.
    A file not yet created counts as no new records; a file that shrank
    (a fresh run truncated it) is read again from the top."""
    offset = 0
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if os.path.getsize(path) < offset:
                offset = 0
            new, offset = _read_new_records(path, offset, kinds)
        except OSError:
            new = []
        for rec in new:
            deadline = time.monotonic() + timeout_s
            yield rec
            if stop_when_done and rec.get("done"):
                return
        if not follow or time.monotonic() >= deadline:
            return
        time.sleep(poll_s)


def tail_heartbeats(path: str, poll_s: float = 0.2,
                    timeout_s: float = 60.0, follow: bool = True,
                    stop_when_done: bool = True) -> Iterator[dict]:
    """:func:`tail_records` of the heartbeat records alone."""
    return tail_records(path, poll_s=poll_s, timeout_s=timeout_s,
                        follow=follow, stop_when_done=stop_when_done,
                        kinds=(HEARTBEAT_KIND,))
