"""The per-round debug callback and the profiler hooks (port of
benor_tpu/utils/tracing.py).

With ``SimConfig(debug=True)`` the round loop emits one event per executed
round, after the round and in order, carrying (round, #decided, #killed):
``k.max()``, ``decided.sum()`` and ``killed.sum()`` over every trial and
node.  The event is fanned out to every registered sink, or to
``default_sink`` when none is registered.  The port's loops run on the
host, so an event is a plain call after the round (three device reads);
the JAX package threads an ordered ``jax.debug.callback`` through its
compiled loop.

Debug is not free on the packed path: the round kernels carry no host
callback, so the packed loop unpacks its plane stack after every round to
read the event (``sim.warn_debug_demotes_pallas`` says so once per
process); the same kernels run and the results are the packed run's.
``SimConfig(record=True)`` observes every round at no such cost.

``profile_trace`` wraps ``torch.profiler`` (CPU activity, and CUDA on the
card) for traces viewable in TensorBoard / Perfetto; ``timed`` wall-clocks
a host block into the metrics registry.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, List

#: Registered sinks; each is called as sink(round, n_decided, n_killed).
_SINKS: List[Callable[[int, int, int], None]] = []


def default_sink(r: int, n_decided: int, n_killed: int) -> None:
    print(f"[benor_tpu] round {int(r)}: decided={int(n_decided)} "
          f"killed={int(n_killed)}", file=sys.stderr, flush=True)


def add_sink(sink: Callable[[int, int, int], None]) -> None:
    _SINKS.append(sink)


def remove_sink(sink: Callable[[int, int, int], None]) -> None:
    _SINKS.remove(sink)


def round_callback(r, n_decided, n_killed) -> None:
    """Host-side fanout, once per executed round."""
    sinks = _SINKS or [default_sink]
    for sink in sinks:
        sink(int(r), int(n_decided), int(n_killed))


def emit_round_event(state) -> None:
    """Emit the round event of ``state`` (the state after the round):
    (k.max(), decided.sum(), killed.sum())."""
    round_callback(state.k.max().item(), state.decided.sum().item(),
                   state.killed.sum().item())


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` capture around a block, written to ``log_dir``
    in TensorBoard's layout (``*.pt.trace.json``, which Perfetto opens).

    Records CPU activity, and CUDA activity where a CUDA device is
    present.  Yields the trace directory, so callers can report where the
    capture landed; each completed capture ticks the
    ``tracing.profile_capture`` counter of the metrics registry."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from .metrics import REGISTRY
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        REGISTRY.counter("tracing.profile_capture").inc()


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock a host-side block; prints to stderr by default.

    Every span also records into the metrics registry (the
    utils/metrics.REGISTRY timer ``label``), so ad-hoc timings show up in
    the JSON-lines / Prometheus / Chrome-trace exports."""
    from .metrics import REGISTRY
    start = time.time()
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    REGISTRY.timer(label).record(dt, start=start)
    msg = f"[benor_tpu] {label}: {dt * 1e3:.1f} ms"
    (sink or (lambda m: print(m, file=sys.stderr, flush=True)))(msg)
