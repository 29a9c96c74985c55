"""ctypes binding for the native C++ event-loop oracle (port of
benor_tpu/backends/native_oracle.py).

Builds the port's own copy of the C++ source,
``benor_tpu_torch/native/express_oracle.cpp`` (the JAX package's
``native/express_oracle.cpp``, code unchanged), with ``g++ -O2 -std=c++17
-shared -fPIC`` into ``build/benor_tpu_torch/oracle/`` at the root of the
checkout, and rebuilds it when the source is newer than the library.  It
never reads or writes ``native/build/``, which the JAX package loads.  A
failed build raises.

The oracle is a host program: it takes no device.  It exists for
large-N differential testing: the drain loop delivers O(N^2) messages a
round, which the Python oracle handles at ~1e6 messages/s and the native
loop at ~1e8.  It is bit-exact with the Python oracle: the C++ side
reimplements CPython's MT19937 (init_by_array seeding, 53-bit doubles), so
coin flips, and hence whole traces, are identical for the same (seed,
scenario).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "express_oracle.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "benor_tpu_torch",
                          "oracle")
_LIB = os.path.join(_BUILD_DIR, "libexpress_oracle.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
#: n, f, max_rounds, seed, step cap, order
_HEAD = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
         ctypes.c_int64, ctypes.c_uint8]


def _build() -> None:
    """Compile the source into the library, through a temporary file and a
    rename, so a concurrent loader never opens a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, _LIB)


def load_library() -> ctypes.CDLL:
    """Load the native oracle library, compiling it if it is absent or
    older than its source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB) or
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.benor_express_run.restype = ctypes.c_int64
        lib.benor_express_run.argtypes = _HEAD + [
            _I8, _U8,                       # values, faulty
            _I8, _U8, _I32, _U8]            # x, decided, k, killed (in/out)
        lib.benor_express_run_inj.restype = ctypes.c_int64
        lib.benor_express_run_inj.argtypes = _HEAD + [
            _I8, _U8,                       # values, faulty
            ctypes.c_int64,                 # n_inj
            _I32, _I32, _I8, _U8,           # inj node, k, x, phase
            _I8, _U8, _I32, _U8]            # x, decided, k, killed (in/out)
        lib.benor_express_run_batch.restype = ctypes.c_int64
        lib.benor_express_run_batch.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # n, f, max_r
            _U32, ctypes.c_int64, ctypes.c_int64,   # seeds, n_seeds, cap
            ctypes.c_uint8,                          # order
            _I8, _U8,                                # values, faulty
            _I8, _U8, _I32, _U8, _I64]               # x, dec, k, killed, steps
        _lib = lib
        return lib


def _check_arrays(n: int, f: int, initial_values, faulty_list) -> None:
    """launchNodes.ts:10-13's validation, in its order and words."""
    if len(initial_values) != len(faulty_list) or n != len(initial_values):
        raise ValueError("Arrays don't match")
    if sum(bool(b) for b in faulty_list) != f:
        raise ValueError("faultyList doesnt have F faulties")


def _default_cap(n: int, max_rounds: int) -> int:
    return max(500_000, 20 * n * n * max_rounds)


def _wire_values(initial_values) -> np.ndarray:
    return np.asarray([2 if v == "?" else int(v) for v in initial_values],
                      np.int8)


def run_batch(cfg, initial_values, faulty_list, seeds,
              step_cap: Optional[int] = None,
              raise_on_cap: bool = False) -> dict:
    """Run the native oracle over an [S] seed vector in ONE ctypes call.

    The same scenario for every seed (values and faults as in
    launch_network); ``cfg.oracle_order`` picks fifo or shuffle delivery.
    Returns numpy arrays: x int8 [S, N] (faulty lanes -1), decided bool
    [S, N], k int32 [S, N] (faulty lanes -1), killed bool [S, N], steps
    int64 [S] (-1 where the seed tripped the step cap), and ``n_tripped``
    (int), how many seeds tripped it: those rows are mid-run snapshots,
    not finished traces.  ``raise_on_cap=True`` turns any trip into a
    RuntimeError.
    """
    n, f = cfg.n_nodes, cfg.n_faulty
    _check_arrays(n, f, initial_values, faulty_list)
    # the oracle replicates the REFERENCE semantics exactly: running a
    # requested extension would fake a wrong scenario's distribution
    for knob, val, want in (("fault_model", cfg.fault_model, "crash"),
                            ("coin_mode", cfg.coin_mode, "private"),
                            ("rule", cfg.rule, "reference"),
                            ("scheduler", cfg.scheduler, "uniform")):
        if val != want:
            raise ValueError(
                f"the native oracle supports only {knob}={want!r} (the "
                f"reference's semantics); got {val!r} — use the 'tpu' "
                "backend")
    seeds = np.ascontiguousarray(seeds, np.uint32)
    s = len(seeds)
    cap = step_cap if step_cap is not None else \
        _default_cap(n, cfg.max_rounds)
    vals = _wire_values(initial_values)
    faulty = np.asarray(faulty_list, bool).astype(np.uint8)
    out_x = np.empty((s, n), np.int8)
    out_dec = np.empty((s, n), np.uint8)
    out_k = np.empty((s, n), np.int32)
    out_killed = np.empty((s, n), np.uint8)
    out_steps = np.empty(s, np.int64)
    lib = load_library()
    lib.benor_express_run_batch(
        n, f, cfg.max_rounds, seeds, s, cap,
        1 if cfg.oracle_order == "shuffle" else 0,
        vals, faulty, out_x.reshape(-1), out_dec.reshape(-1),
        out_k.reshape(-1), out_killed.reshape(-1), out_steps)
    n_tripped = int((out_steps < 0).sum())
    if raise_on_cap and n_tripped:
        raise RuntimeError(
            f"native oracle: {n_tripped}/{s} seeds tripped the step cap "
            f"({cap}); raise step_cap or shrink the scenario")
    return {"x": out_x, "decided": out_dec.astype(bool), "k": out_k,
            "killed": out_killed.astype(bool), "steps": out_steps,
            "n_tripped": n_tripped}


def native_available() -> bool:
    """Whether the native oracle can run here: False only where ``g++``
    is missing (a build that fails for another reason raises)."""
    try:
        load_library()
        return True
    except FileNotFoundError:
        if shutil.which("g++") is None:
            return False
        raise


class NativeExpressNetwork:
    """Parity-API network running the C++ oracle (one trial, as the Python
    oracle).  The validation messages are launchNodes.ts:10-13's."""

    def __init__(self, cfg, initial_values, faulty_list,
                 step_cap: Optional[int] = None):
        n, f = cfg.n_nodes, cfg.n_faulty
        if cfg.trials != 1:
            raise ValueError(
                "the express oracle simulates a single trial; use the 'tpu' "
                "backend for Monte-Carlo (trials > 1) runs")
        _check_arrays(n, f, initial_values, faulty_list)
        if not (0 <= cfg.seed < 2**32):
            # the C++ MT19937 implements only the single-word init_by_array
            # path; a truncated seed would diverge from the Python oracle
            raise ValueError(
                "native oracle requires 0 <= seed < 2**32 for bit-exact "
                "parity with the Python oracle")
        self.cfg = cfg
        self.n, self.f = n, f
        self._step_cap = step_cap if step_cap is not None else \
            _default_cap(n, cfg.max_rounds)
        self._vals = _wire_values(initial_values)
        self._faulty = np.asarray(faulty_list, bool).astype(np.uint8)
        self._x = self._vals.copy()
        self._decided = np.zeros(n, np.uint8)
        self._k = np.zeros(n, np.int32)
        self._killed = self._faulty.copy()
        self._started = False
        self._inj: list = []          # pre-start POST /message buffer

    def status(self, node_id: int, trial: int = 0):
        self._check_trial(trial)
        return ("faulty", 500) if self._killed[node_id] else ("live", 200)

    def inject_message(self, node_id: int, k, x, message_type) -> bool:
        """The reference's POST /message (node.ts:43-163), before start()
        only on this backend.

        Buffered here and handed to ``benor_express_run_inj``, which puts
        the messages in the delivery queue ahead of the /start fan-out,
        where the Python oracle's pre-start inject_message puts them: the
        traces stay bit-equal across the oracles for either order.
        Returns False iff the target is killed (the reference's 200 sits
        inside its ``!killed`` guard).  Raises NotImplementedError once
        started: the C++ engine runs a whole trial in one call.
        """
        if self._started:
            raise NotImplementedError(
                "post-start injection is not supported on the batched "
                "native oracle; use backend='express'")
        if not -self.n <= node_id < self.n:
            raise IndexError("node_id out of range")   # list-index parity
        if node_id < 0:
            # the Python oracle's nodes[node_id] takes negative indices;
            # the C++ side drops raw negatives, which would fork the traces
            node_id += self.n
        if self._killed[node_id]:
            return False
        if not isinstance(k, int) or isinstance(k, bool) or \
                not (0 <= k <= self.cfg.max_rounds + 1):
            # the C++ tally buffers are sized max_rounds + 2
            raise ValueError(
                "native oracle injection requires 0 <= k <= "
                f"max_rounds + 1 (= {self.cfg.max_rounds + 1}); got {k!r}")
        # Unknown types are delivered as no-ops (phase 2): they still take
        # a queue slot, so the shuffle permutation matches the Python
        # oracle's.  x is classed with Python ``==``, as list.count tallies
        # it there: 0-equal, 1-equal, or neither (counted toward the
        # quorum, quirk 4, like "?").
        phase = {"proposal phase": 0, "voting phase": 1}.get(message_type, 2)
        xv = 0 if x == 0 else (1 if x == 1 else 2)
        self._inj.append((node_id, k, xv, phase))
        return True

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        lib = load_library()
        # _killed is in/out: a pre-start stop()/stop_node() is the initial
        # killed mask, as in the Python oracle
        order = 1 if self.cfg.oracle_order == "shuffle" else 0
        head = (self.n, self.f, self.cfg.max_rounds, self.cfg.seed,
                self._step_cap, order, self._vals, self._faulty)
        state = (self._x, self._decided, self._k, self._killed)
        if self._inj:
            inj = np.asarray(self._inj, np.int64).reshape(-1, 4)
            steps = lib.benor_express_run_inj(
                *head, len(self._inj),
                np.ascontiguousarray(inj[:, 0], np.int32),
                np.ascontiguousarray(inj[:, 1], np.int32),
                np.ascontiguousarray(inj[:, 2], np.int8),
                np.ascontiguousarray(inj[:, 3], np.uint8), *state)
        else:
            steps = lib.benor_express_run(*head, *state)
        if steps < 0:
            raise RuntimeError(
                f"native oracle exceeded its step cap ({self._step_cap} "
                f"deliveries) before settling")
        self.steps_delivered = int(steps)

    def stop(self) -> None:
        self._killed[:] = 1

    def stop_node(self, node_id: int) -> None:
        self._killed[node_id] = 1

    @staticmethod
    def _check_trial(trial: int) -> None:
        if trial != 0:
            raise IndexError("express oracle has a single trial (index 0)")

    def get_state(self, node_id: int, trial: int = 0) -> dict:
        self._check_trial(trial)
        if self._faulty[node_id]:
            return {"killed": True, "x": None, "decided": None, "k": None}
        x = int(self._x[node_id])
        return {"killed": bool(self._killed[node_id]),
                "x": "?" if x == 2 else x,
                "decided": bool(self._decided[node_id]),
                "k": int(self._k[node_id])}

    def get_states(self, trial: int = 0) -> List[dict]:
        self._check_trial(trial)
        return [self.get_state(i) for i in range(self.n)]

    def close(self) -> None:
        pass
