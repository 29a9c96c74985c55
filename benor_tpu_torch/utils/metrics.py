"""Flight-recorder rendering: recorder buffers -> host structures (port of
benor_tpu/utils/metrics.py:286-380), the atomic file write the atlas
manifests and heatmaps go through (metrics.py:390-397) and the line-atomic
JSON-lines append the sweep and atlas journals write with
(metrics.py:400-409).  The rest of that module (the metric registry, span
log and exporters) waits for the observatory planes (ROADMAP Queue A item
16)."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

import numpy as np

from ..state import (REC_COLUMNS, REC_DECIDED, REC_UNDEC0, REC_UNDEC1,
                     REC_UNDECQ)


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


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file and a rename, so
    a concurrent reader sees the old whole file or the new one, never a
    part."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


_APPEND_LOCK = threading.Lock()


def append_jsonl(path: str, record: dict) -> None:
    """Append one record as a timestamped JSON line, serialised first and
    written in one call under a lock, so appenders in one process never
    interleave bytes and a reader always parses every whole line."""
    line = json.dumps({"ts": time.time(), **record}) + "\n"
    with _APPEND_LOCK:
        with open(path, "a") as fh:
            fh.write(line)
