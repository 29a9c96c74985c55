"""Build-ahead / run-behind bucket scheduler for the batched sweep (port of
benor_tpu/sweep_async.py:44-95).

One worker thread runs the build leg of each bucket (fault specs,
fingerprint, journal match, the state tensors, the kernel library's build
or load) strictly in bucket order, while the caller's thread runs the
bucket before it.  The handoff queue holds at most one built bucket, so at
most two buckets' tensors are alive at once.  Everything ordered — the
run, the fetch, the journal records, the heartbeat beats, the verbose
lines — stays on the
caller's thread in bucket order, so results, per-bucket counts and
journal contents equal the serial dispatch; only the wall clock changes.
A build's exception is raised on the caller's thread at the bucket it
belongs to, as the serial loop would raise it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence, Tuple

__all__ = ["pipeline_buckets"]

#: Queue depth of the build-ahead handoff: one staged bucket.
PIPELINE_DEPTH = 1


def pipeline_buckets(work: Sequence[Tuple], build: Callable,
                     depth: int = PIPELINE_DEPTH) -> Iterator:
    """Yield ``build(*item)`` for each work item, building one ahead on a
    daemon worker thread, in work order."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()
    _done = object()

    def _worker():
        try:
            for item in work:
                if stop.is_set():
                    return
                q.put(("plan", build(*item)))
        # benorlint: allow-broad-except — cross-thread relay boundary:
        # whatever the build raised (a kernel-library build failure
        # included) is re-raised verbatim on the consuming thread, in
        # bucket order; nothing is swallowed and nothing falls back
        except BaseException as e:
            q.put(("raise", e))
            return
        q.put(("done", _done))

    t = threading.Thread(target=_worker, name="sweep-build-ahead",
                         daemon=True)
    t.start()
    try:
        while True:
            tag, payload = q.get()
            if tag == "done":
                break
            if tag == "raise":
                raise payload
            yield payload
    finally:
        # normal exit or an abandoned consumer: stop the worker, free a
        # blocked put, and let a build already in flight finish
        stop.set()
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=60.0)
