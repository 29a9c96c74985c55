"""Public launch facade — the reference's orchestration layer (port of
benor_tpu/api.py:19-81).

``launch_network`` mirrors ``launchNetwork(N, F, initialValues,
faultyList)`` (reference src/index.ts:4-14 -> launchNodes.ts:4-44);
``start_consensus`` / ``stop_consensus`` mirror src/nodes/consensus.ts.
``backend='tpu'`` is the device simulator; ``'express'`` and ``'native'``
are the event-loop oracles, host programs that take no device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .backends.express import ExpressNetwork
from .backends.tpu import TpuNetwork
from .config import SimConfig


def launch_network(n: int, f: int, initial_values: Sequence,
                   faulty_list: Sequence[bool], backend: Optional[str] = None,
                   cfg: Optional[SimConfig] = None, device=None,
                   crash_rounds=None, **cfg_overrides):
    """Launch a simulated network; returns a network with the parity API
    (status / start / stop / get_state / get_states).  The 'tpu' backend
    runs on the CUDA device unless ``device`` names the CPU; the oracles
    ('express', 'native') run on the host and take no device.
    ``crash_rounds`` (int[N], the round each faulty node dies at; <= 0:
    never) is required for fault_model='crash_at_round'.

    ``backend`` defaults to ``cfg.backend`` when a config is given, else
    'tpu'.  Validation matches launchNodes.ts:10-13: array lengths must
    equal N and ``faulty_list`` must contain exactly ``f`` true entries.
    """
    if cfg is None:
        cfg = SimConfig(n_nodes=n, n_faulty=f,
                        backend=backend or "tpu", **cfg_overrides)
    else:
        cfg = cfg.replace(n_nodes=n, n_faulty=f,
                          backend=backend or cfg.backend, **cfg_overrides)
    if cfg.backend in ("express", "native"):
        # The oracles replicate the REFERENCE's semantics exactly: crash-
        # from-birth faults (node.ts:21-26), private Math.random() coins
        # (node.ts:111), the plurality-adopt rule (node.ts:106-112) and
        # their own event-loop delivery order (cfg.oracle_order, never
        # cfg.scheduler).  Running them for a requested extension would
        # fake a parity they cannot give.
        for knob, val, want in (("fault_model", cfg.fault_model, "crash"),
                                ("coin_mode", cfg.coin_mode, "private"),
                                ("rule", cfg.rule, "reference"),
                                ("scheduler", cfg.scheduler, "uniform")):
            if val != want:
                raise ValueError(
                    f"backend={cfg.backend!r} supports only {knob}="
                    f"{want!r} (the reference's semantics); got {val!r} — "
                    f"use backend='tpu'")
    if cfg.backend == "express":
        return ExpressNetwork(cfg, list(initial_values), list(faulty_list))
    if cfg.backend == "native":
        from .backends.native_oracle import NativeExpressNetwork
        return NativeExpressNetwork(cfg, list(initial_values),
                                    list(faulty_list))
    return TpuNetwork(cfg, list(initial_values), list(faulty_list),
                      crash_rounds=crash_rounds, device=device)


def start_consensus(network) -> None:
    """consensus.ts:3-8 — kick off the protocol on every node."""
    network.start()


def stop_consensus(network) -> None:
    """consensus.ts:10-15 — kill every node."""
    network.stop()


def get_nodes_state(network, trial: int = 0) -> List[dict]:
    """__test__/tests/utils.ts:14-20 — scrape all node states."""
    return network.get_states(trial)


def reached_finality(states: List[dict]) -> bool:
    """__test__/tests/utils.ts:22-24 — no state has decided === false
    (faulty nodes' null counts as final)."""
    return all(s["decided"] is not False for s in states)
