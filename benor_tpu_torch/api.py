"""Public launch facade — the reference's orchestration layer (port of
benor_tpu/api.py:19-81).

``launch_network`` mirrors ``launchNetwork(N, F, initialValues,
faultyList)`` (reference src/index.ts:4-14 -> launchNodes.ts:4-44);
``start_consensus`` / ``stop_consensus`` mirror src/nodes/consensus.ts.
Only ``backend='tpu'``, the device simulator, is ported: the event-loop
oracles raise ``NotImplementedError`` (ROADMAP Queue A item 17).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .backends.tpu import TpuNetwork
from .config import SimConfig, unported


def launch_network(n: int, f: int, initial_values: Sequence,
                   faulty_list: Sequence[bool], backend: Optional[str] = None,
                   cfg: Optional[SimConfig] = None, device=None,
                   **cfg_overrides) -> TpuNetwork:
    """Launch a simulated network; returns a network with the parity API
    (status / start / stop / get_state / get_states), on the CUDA device
    unless ``device`` names the CPU.

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
        unported(f"backend={cfg.backend!r} (the event-loop oracles)", "17")
    return TpuNetwork(cfg, list(initial_values), list(faulty_list),
                      device=device)


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
