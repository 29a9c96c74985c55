"""Host-side metrics: one process-wide registry, a span log, three
exporters, and the flight-recorder rendering (port of
benor_tpu/utils/metrics.py, stdlib and numpy only).

The registry holds counters, gauges and timers that the instrumented
modules feed (the demotion announcers in sim.py, the sweep journal, the
atlas, the auditor, ``utils/tracing.timed``, the CLI), and exports as:

  * JSON-lines   (``export_jsonl``)      — one metric per line, grep/jq-able
  * Prometheus   (``export_prometheus``) — textfile-collector format
  * Chrome trace (``export_chrome_trace``) — Perfetto / chrome://tracing;
    timer spans render as complete events on the host track, and a
    flight-recorder buffer (SimConfig.record) renders as one trace slice
    per protocol round on a synthetic round track.

The documents are the JAX package's for the same metrics.  The JAX
package's XLA-only counters (``jax.backend_compiles*``, the
``backend.probe_*`` of its TPU probe) have no counterpart here.  The
module is import-cheap: the device loops never pay for host bookkeeping.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..state import (REC_COLUMNS, REC_DECIDED, REC_UNDEC0, REC_UNDEC1,
                     REC_UNDECQ)

# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Counter:
    """Monotone accumulator (events, compiles, probe attempts)."""

    name: str
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with _REGISTRY_LOCK:
            self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-write-wins sample (sizes, utilizations, platform flags)."""

    name: str
    value: float = 0.0

    def set(self, value: float) -> None:
        with _REGISTRY_LOCK:
            self.value = float(value)


@dataclasses.dataclass
class Timer:
    """Duration accumulator; keeps per-span events for the trace export."""

    name: str
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    #: (start wall-clock epoch seconds, duration seconds) per span, in
    #: record order — the Chrome-trace exporter's raw material.
    events: List = dataclasses.field(default_factory=list)

    def record(self, seconds: float, start: Optional[float] = None) -> None:
        with _REGISTRY_LOCK:
            self.count += 1
            self.total_s += seconds
            self.min_s = min(self.min_s, seconds)
            self.max_s = max(self.max_s, seconds)
            self.events.append(
                (time.time() - seconds if start is None else start, seconds))

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        start = time.time()
        yield
        self.record(time.perf_counter() - t0, start=start)

    def percentiles(self, qs=(50, 99)) -> Dict[int, float]:
        """Span-duration percentiles in SECONDS, from the recorded
        events — what a latency timer reduces to for p50/p99 reporting.
        Empty timer -> an empty dict (no fabricated zeros)."""
        with _REGISTRY_LOCK:
            durs = [d for _, d in self.events]
        if not durs:
            return {}
        return {int(q): float(np.percentile(np.asarray(durs), q))
                for q in qs}


_REGISTRY_LOCK = threading.RLock()


class MetricsRegistry:
    """Process-wide named metric store.  ``counter``/``gauge``/``timer``
    are get-or-create (idempotent, thread-safe); ``snapshot`` returns
    plain dicts for the exporters."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with _REGISTRY_LOCK:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name=name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def snapshot(self) -> List[dict]:
        """All metrics as JSON-able dicts (one per metric, typed)."""
        out = []
        with _REGISTRY_LOCK:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if isinstance(m, Counter):
                    out.append({"name": name, "type": "counter",
                                "value": m.value})
                elif isinstance(m, Gauge):
                    out.append({"name": name, "type": "gauge",
                                "value": m.value})
                else:
                    out.append({
                        "name": name, "type": "timer", "count": m.count,
                        "total_s": round(m.total_s, 6),
                        "min_s": (round(m.min_s, 6) if m.count else None),
                        "max_s": round(m.max_s, 6),
                    })
        return out

    def reset(self) -> None:
        """Drop every metric (tests only — the registry is process-global)."""
        with _REGISTRY_LOCK:
            self._metrics.clear()


#: The process-wide registry every instrumented module feeds.
REGISTRY = MetricsRegistry()


# --------------------------------------------------------------------------
# Spans: explicit intervals with parents and flow links
# --------------------------------------------------------------------------

#: Anchor for converting ``time.perf_counter()`` stamps (monotonic,
#: comparable across threads) into wall-clock epoch seconds for the Chrome-trace timeline.  Captured
#: once at import so every span shares one consistent offset.
_PERF_EPOCH = time.time() - time.perf_counter()


def perf_to_epoch(t_perf: float) -> float:
    """A ``time.perf_counter()`` stamp -> epoch seconds (trace domain)."""
    return t_perf + _PERF_EPOCH


@dataclasses.dataclass
class Span:
    """One traced interval: explicit start/duration (seconds, epoch
    domain — use :func:`perf_to_epoch` on perf_counter stamps),
    parent/child structure via ``parent_id`` and Perfetto flow links via
    ``flow_in``/``flow_out`` (flow ids BEGIN at this span / TERMINATE at
    this span — how a batch-level span points at the job slots it
    carried).  ``track`` is the trace row (Chrome-trace ``tid``)."""

    name: str
    start: float
    dur_s: float
    track: str = "host"
    span_id: int = 0
    parent_id: Optional[int] = None
    flow_in: Tuple[int, ...] = ()
    flow_out: Tuple[int, ...] = ()
    args: Dict = dataclasses.field(default_factory=dict)


def _as_ids(v: Union[None, int, Tuple[int, ...], List[int]]) -> Tuple:
    if v is None:
        return ()
    if isinstance(v, int):
        return (v,)
    return tuple(v)


class SpanLog:
    """The process-wide span plane.  DISABLED by default: ``add`` is a
    no-op returning 0, so instrumented code pays one attribute read when
    tracing is off — and, because spans only consume host-side
    ``perf_counter`` stamps that are taken regardless, tracing on or off
    changes no device result.

    ``cap`` bounds retained spans so a long-lived server with tracing
    enabled cannot grow without limit; overflow increments ``dropped``
    (surfaced in the export) instead of silently evicting."""

    def __init__(self, cap: int = 200_000):
        self.enabled = False
        self.cap = cap
        self.dropped = 0
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._flows = itertools.count(1)
        self._lock = threading.Lock()

    def enable(self) -> "SpanLog":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def new_flow(self) -> int:
        """A fresh flow id (links an emitting span to consumers)."""
        return next(self._flows)

    def add(self, name: str, start: float, dur_s: float, *,
            track: str = "host", parent_id: Optional[int] = None,
            flow_in=None, flow_out=None,
            args: Optional[Dict] = None) -> int:
        """Record one span; returns its span id (0 when disabled)."""
        if not self.enabled:
            return 0
        span = Span(name=name, start=start, dur_s=max(0.0, dur_s),
                    track=track, span_id=next(self._ids),
                    parent_id=parent_id, flow_in=_as_ids(flow_in),
                    flow_out=_as_ids(flow_out), args=dict(args or {}))
        with self._lock:
            if len(self._spans) >= self.cap:
                self.dropped += 1
                return 0
            self._spans.append(span)
        return span.span_id

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


#: The process-wide span log (off until ``SPANS.enable()``).
SPANS = SpanLog()


# --------------------------------------------------------------------------
# Flight-recorder rendering (SimConfig.record buffers -> host structures)
# --------------------------------------------------------------------------


def _host(recorder) -> np.ndarray:
    """A recorder buffer (tensor or array, on any device) as int64 numpy."""
    if hasattr(recorder, "cpu"):
        recorder = recorder.cpu().numpy()
    return np.asarray(recorder).astype(np.int64)


def written_round_indices(recorder) -> np.ndarray:
    """Indices of the rows the loop wrote, ascending: a written row's
    decided + killed + undecided classes sum to T * N >= 1, an unwritten
    one is all zero.  A resume with a fresh buffer leaves a gap: row 0
    snapshots the re-entry state and the next written row is the re-entry
    round."""
    return np.nonzero(_host(recorder)[:, :5].sum(axis=1) > 0)[0]


def executed_rows(recorder) -> np.ndarray:
    """The written rows, int64 [n_written, REC_WIDTH]."""
    return _host(recorder)[written_round_indices(recorder)]


def round_history_rows(recorder,
                       since_round: Optional[int] = None) -> List[dict]:
    """One dict per written row, REC_COLUMNS-keyed plus its round index
    ("round": 0 is the post-/start snapshot).  ``since_round`` is a
    cursor: only rows of a strictly greater round are returned."""
    rec = _host(recorder)
    rows = []
    for r in written_round_indices(recorder):
        if since_round is not None and int(r) <= int(since_round):
            continue
        d = {"round": int(r)}
        d.update({col: int(v) for col, v in zip(REC_COLUMNS, rec[r])})
        rows.append(d)
    return rows


def round_history_summary(recorder) -> dict:
    """What a recorder buffer says of its run, under bench.py's keys:
    rounds_executed (written rows but the snapshot), rounds_to_quiescence
    (the first written round with no undecided live lane, or None),
    decide_velocity (newly decided lanes between written rows; also as
    rounds_to_quiescence_hist) and final (the last written row)."""
    rows = executed_rows(recorder)
    undec = rows[:, REC_UNDEC0] + rows[:, REC_UNDEC1] + rows[:, REC_UNDECQ]
    quiesced = np.nonzero(undec == 0)[0]
    idx = written_round_indices(recorder)
    velocity = np.diff(rows[:, REC_DECIDED]).tolist()
    return {
        "rounds_executed": int(rows.shape[0] - 1),
        "rounds_to_quiescence": (int(idx[quiesced[0]]) if quiesced.size
                                 else None),
        "decide_velocity": velocity,
        "rounds_to_quiescence_hist": velocity,
        "final": {c: int(v) for c, v in zip(REC_COLUMNS, rows[-1])},
    }


# --------------------------------------------------------------------------
# Exporters
#
# Metric mutation is serialized on _REGISTRY_LOCK; the exporters write
# whole-file snapshots through a temporary file and os.replace(), so a
# concurrent reader never sees a torn document, and line appends
# (append_jsonl) are serialized on _EXPORT_LOCK with one write() a line.
# --------------------------------------------------------------------------

_EXPORT_LOCK = threading.Lock()


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file and a rename, so
    a concurrent reader sees the old whole file or the new one, never a
    part."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def append_jsonl(path: str, record: dict) -> None:
    """Append one record as a timestamped JSON line, serialised first and
    written in one call under a lock, so appenders in one process never
    interleave bytes and a reader always parses every whole line."""
    line = json.dumps({"ts": time.time(), **record}) + "\n"
    with _EXPORT_LOCK:
        with open(path, "a") as fh:
            fh.write(line)


def export_jsonl(path: str, registry: MetricsRegistry = None,
                 extra: Optional[List[dict]] = None) -> int:
    """Write the registry snapshot (plus optional extra records, e.g.
    round_history_rows) as JSON-lines; returns the record count.
    Atomic (temp file + rename): a concurrent reader never sees a
    half-written snapshot."""
    registry = REGISTRY if registry is None else registry
    records = registry.snapshot() + list(extra or [])
    ts = time.time()
    text = "".join(json.dumps({"ts": ts, **rec}) + "\n"
                   for rec in records)
    with _EXPORT_LOCK:
        _atomic_write(path, text)
    return len(records)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    return prefix + _PROM_BAD.sub("_", name)


def export_prometheus(path: str, registry: MetricsRegistry = None,
                      prefix: str = "benor_tpu_") -> int:
    """Write the registry in Prometheus textfile-collector format (the
    node_exporter drop-in contract: ``# TYPE`` headers + bare samples;
    timers expand to _count/_seconds_total/_seconds_max).  Returns the
    sample count."""
    registry = REGISTRY if registry is None else registry
    lines = []
    n = 0
    for m in registry.snapshot():
        name = _prom_name(m["name"], prefix)
        if m["type"] in ("counter", "gauge"):
            lines.append(f"# TYPE {name} {m['type']}")
            lines.append(f"{name} {m['value']}")
            n += 1
        else:
            lines.append(f"# TYPE {name}_count counter")
            lines.append(f"{name}_count {m['count']}")
            lines.append(f"# TYPE {name}_seconds_total counter")
            lines.append(f"{name}_seconds_total {m['total_s']}")
            lines.append(f"# TYPE {name}_seconds_max gauge")
            lines.append(f"{name}_seconds_max {m['max_s']}")
            n += 3
    with _EXPORT_LOCK:
        _atomic_write(path, "\n".join(lines) + "\n")
    return n


def export_chrome_trace(path: str, registry: MetricsRegistry = None,
                        round_history=None,
                        rounds_label: str = "consensus",
                        witness=None, spans=None) -> int:
    """Write a Chrome-trace/Perfetto JSON file; returns the event count.

    Timer spans land on pid 0 / tid "host" as complete ("X") events at
    their real wall-clock offsets.  ``round_history`` (a flight-recorder
    buffer) lands on tid "rounds" with a SYNTHETIC 1 ms-per-round
    timescale — the recorder is filled on device with no per-round host
    timestamps (that is the point) — each slice carrying its full
    telemetry row in ``args``.  ``witness`` (an audit.WitnessBundle, or
    a witness buffer paired with its watched ids as ``(buffer,
    trial_ids, node_ids)``) adds one track per watched (trial, node)
    lane on the same synthetic timescale, each round-slice carrying the
    lane's full evidence row (value, decided/killed/coined bits, p/v
    tallies) — the flight recorder's aggregates and the per-node
    forensics line up round for round.  Counters/gauges become metadata
    counter events.  ``spans`` renders a span set (``True``
    for the process-wide :data:`SPANS` log, or an explicit Span list):
    each span is a complete event on its own track, parent ids ride in
    ``args``, and ``flow_out``/``flow_in`` ids become Chrome-trace flow
    start ("s") / finish ("f") event pairs — Perfetto draws the arrow
    from a batch launch to every job slot it carried.  Open in
    https://ui.perfetto.dev or chrome://tracing; a ``torch.profiler``
    capture of the same run (``utils.tracing.profile_trace``) sits
    alongside as separate tracks when loaded together.
    """
    registry = REGISTRY if registry is None else registry
    if spans is True:
        spans = SPANS.snapshot()
    events = []
    t0 = None
    snap = registry.snapshot()
    with _REGISTRY_LOCK:
        timers = [(m.name, list(m.events))
                  for m in registry._metrics.values()
                  if isinstance(m, Timer)]
    for _, evs in timers:
        for start, _ in evs:
            t0 = start if t0 is None else min(t0, start)
    for sp in spans or ():
        t0 = sp.start if t0 is None else min(t0, sp.start)
    t0 = t0 or time.time()
    for name, evs in timers:
        for start, dur in evs:
            events.append({
                "name": name, "ph": "X", "pid": 0, "tid": "host",
                "ts": (start - t0) * 1e6, "dur": dur * 1e6,
            })
    for m in snap:
        if m["type"] in ("counter", "gauge"):
            events.append({
                "name": m["name"], "ph": "C", "pid": 0, "ts": 0,
                "args": {m["type"]: m["value"]},
            })
    if round_history is not None:
        for row in round_history_rows(round_history):
            r = row["round"]
            events.append({
                "name": (f"{rounds_label} round {r}" if r
                         else f"{rounds_label} start"),
                "ph": "X", "pid": 0, "tid": "rounds",
                "ts": r * 1000.0, "dur": 1000.0,
                "args": {k: v for k, v in row.items() if k != "round"},
            })
    if witness is not None:
        from ..audit import witness_rows
        if hasattr(witness, "buffer"):              # a WitnessBundle
            buf, tids, nids = (witness.buffer, witness.trial_ids,
                               witness.node_ids)
        else:
            buf, tids, nids = witness
        for row in witness_rows(buf, tids, nids):
            r = row["round"]
            events.append({
                "name": (f"x={row['x']}"
                         + (" decided" if row["decided"] else "")
                         + (" killed" if row["killed"] else "")
                         + (" coin" if row["coined"] else "")),
                "ph": "X", "pid": 0,
                "tid": f"witness t{row['trial']} n{row['node']}",
                "ts": r * 1000.0, "dur": 1000.0,
                "args": {k: v for k, v in row.items()
                         if k not in ("round", "trial", "node")},
            })
    for sp in spans or ():
        ts = (sp.start - t0) * 1e6
        dur = sp.dur_s * 1e6
        args = dict(sp.args)
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        events.append({"name": sp.name, "ph": "X", "pid": 0,
                       "tid": sp.track, "ts": ts, "dur": dur,
                       "args": args})
        # flow arrows: an id STARTS ("s") where flow_out names it and
        # FINISHES ("f", binding enclosing slice) where flow_in does —
        # the s event anchors at the span start, the f at the span start
        # too so the arrow lands on the consumer slice's left edge
        for fid in sp.flow_out:
            events.append({"name": "flow", "ph": "s", "id": fid,
                           "pid": 0, "tid": sp.track, "ts": ts})
        for fid in sp.flow_in:
            events.append({"name": "flow", "ph": "f", "bp": "e",
                           "id": fid, "pid": 0, "tid": sp.track,
                           "ts": ts})
    if spans is not None and SPANS.dropped:
        events.append({"name": "spans_dropped", "ph": "C", "pid": 0,
                       "ts": 0, "args": {"counter": SPANS.dropped}})
    with _EXPORT_LOCK:
        _atomic_write(path, json.dumps({"traceEvents": events,
                                        "displayTimeUnit": "ms"}))
    return len(events)
