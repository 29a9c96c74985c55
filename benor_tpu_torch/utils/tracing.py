"""The per-round debug callback (port of benor_tpu/utils/tracing.py:38-96).

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
``SimConfig(record=True)`` observes every round at no such cost.  The profiler hooks (``profile_trace``, ``timed``) come with the
observatory planes (ROADMAP Queue A item 16).
"""

from __future__ import annotations

import sys
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
