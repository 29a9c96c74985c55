"""The device-array network: the reference's observable contract over the
port's [trials, N] tensors (port of benor_tpu/backends/tpu.py:32-310).

``backend='tpu'`` is the ``SimConfig`` value that selects the device
simulator in both packages; in this one it runs on the CUDA device (or on
the CPU when the caller passes ``device="cpu"``).  The four HTTP routes of
the reference's src/nodes/node.ts:

  /status   -> status(i)        node.ts:33-39
  /start    -> start()          node.ts:167-188 (+ consensus.ts:3-8 fan-out)
  /stop     -> stop()           node.ts:191-194 (+ consensus.ts:10-15)
  /getState -> get_state(i)     node.ts:197-199

``start()`` runs the whole consensus to termination (or the round cap) in
one call by default; ``SimConfig(poll_rounds=c)`` steps the loop in
c-round slices instead, republishing ``self.state`` between slices, with a
final state equal to the one-shot run's bit for bit.  With
``SimConfig(heartbeat_rounds=h)`` the run publishes progress beats
(meshscope/heartbeat.py) between slices, and one final beat, into the
metrics registry and, when ``heartbeat_path`` is set, a JSON-lines file;
the run itself is unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import sim
from ..config import VALQ, SimConfig
from ..models.benor import all_settled
from ..state import FaultSpec, NetState, init_state, observable_state


def _decided_frac(state: NetState) -> Optional[float]:
    """Decided fraction over decided + live undecided lanes, the classes
    the flight recorder counts, so a beat's decided_frac means the same
    with cfg.record on or off (backends/tpu.py:32-40)."""
    decided = int(state.decided.sum())
    undec = int((~state.decided & ~state.killed).sum())
    return decided / (decided + undec) if (decided + undec) else None


class TpuNetwork:
    """One simulated network (all trials of it) behind the parity API."""

    def __init__(self, cfg: SimConfig, initial_values, faulty_list,
                 crash_rounds=None, device=None,
                 heartbeat_path: Optional[str] = None):
        # Validation order and messages mirror launchNodes.ts:10-13.
        if len(initial_values) != len(faulty_list) or \
                cfg.n_nodes != len(initial_values):
            raise ValueError("Arrays don't match")
        sim.check_supported(cfg)
        self.cfg = cfg
        #: The JSON-lines file the progress heartbeat (cfg.heartbeat_rounds)
        #: appends to, what ``watch`` tails; the registry's gauges are fed
        #: either way.  Assignable after construction too.
        self.heartbeat_path = heartbeat_path
        dev = sim.resolve_device(device)
        self.faults = FaultSpec.from_faulty_list(cfg, faulty_list,
                                                 crash_rounds, device=dev)
        self.state: NetState = init_state(cfg, initial_values, self.faults)
        self._started = False
        self.rounds_executed = 0
        self._recorder = None            # cfg.record: the round history
        self._witness = None             # cfg.witness: the witness buffer

    # -- /status (node.ts:33-39) ----------------------------------------
    def status(self, node_id: int, trial: int = 0):
        """Returns (body, http_code): ("faulty", 500) | ("live", 200)."""
        killed = bool(self.state.killed[trial, node_id].item())
        return ("faulty", 500) if killed else ("live", 200)

    # -- /start (consensus.ts:3-8 -> node.ts:167-188) --------------------
    def start(self, on_slice=None) -> None:
        """Run consensus to termination (or the round cap).

        With ``cfg.poll_rounds > 0`` the loop runs in slices of that many
        rounds and ``self.state`` is republished after every slice (k = 1
        visible first), so a reader observes a live, still-undecided
        network with growing k (benorconsensus.test.ts:149-160).
        ``on_slice`` (optional callable, no arguments) fires after each
        publish.  Final state and ``rounds_executed`` equal the one-shot
        run's.  Under cfg.record / cfg.witness the recorder and the witness
        buffer are carried from slice to slice and kept after the run, for
        ``get_round_history`` / ``get_witness`` (between slices they hold
        the rounds run so far).  Under cfg.heartbeat_rounds a beat is
        published whenever the round cursor crosses a multiple of it
        (``sim.heartbeat_due``) and a final one, ``done: true``, at the
        end; a one-shot run publishes the final beat alone."""
        if self._started:
            return
        if on_slice is not None and not self.cfg.poll_rounds > 0:
            raise ValueError(
                "start(on_slice=...) requires SimConfig(poll_rounds > 0); "
                "this config runs one uninterrupted loop")
        heartbeat = None
        if self.cfg.heartbeat_rounds:
            # host-side beats between slices: the slices are untouched
            from ..meshscope.heartbeat import HeartbeatPublisher
            heartbeat = HeartbeatPublisher(
                self.cfg, path=self.heartbeat_path,
                label=f"net N={self.cfg.n_nodes}")
        if self.cfg.poll_rounds > 0:
            state = sim.start_state(self.cfg, self.state)
            self.state = state               # k=1 visible (node.ts:172)
            r = 1
            while True:
                out = sim.run_consensus_slice(
                    self.cfg, state, self.faults, r,
                    r + self.cfg.poll_rounds, self._recorder, self._witness)
                r_next, state = out[0], out[1]
                self._keep(out)
                self.state = state           # publish the live snapshot
                if on_slice is not None:
                    on_slice()
                if heartbeat is not None and sim.heartbeat_due(
                        self.cfg, r - 1, r_next - 1):
                    heartbeat.publish(
                        r_next - 1, recorder=self._recorder,
                        decided_frac=(None if self.cfg.record
                                      else _decided_frac(state)))
                if (r_next == r or r_next > self.cfg.max_rounds
                        or bool(all_settled(state))):
                    break
                r = r_next
            self.rounds_executed = r_next - 1
        else:
            out = sim.run_consensus(self.cfg, self.state, self.faults)
            self.rounds_executed, self.state = out[0], out[1]
            self._keep(out)
        if heartbeat is not None:
            # a one-shot run has no boundary to beat at: its one record is
            # the final state, so `watch` is never left on an empty file
            heartbeat.close(self.rounds_executed, recorder=self._recorder)
        self._started = True

    def _keep(self, out) -> None:
        """Keep the recorder and witness buffer of a loop's return (they
        follow the round and the state, in that order)."""
        i = 2
        if self.cfg.record:
            self._recorder = out[i]
            i += 1
        if self.cfg.witness:
            self._witness = out[i]

    # -- /stop (consensus.ts:10-15 -> node.ts:191-194) -------------------
    def stop(self) -> None:
        self.state = NetState(
            x=self.state.x, decided=self.state.decided, k=self.state.k,
            killed=torch.ones_like(self.state.killed))

    def stop_node(self, node_id: int) -> None:
        """Single node's /stop route (node.ts:191-194), all trials."""
        killed = self.state.killed.clone()
        killed[:, node_id] = True
        self.state = NetState(x=self.state.x, decided=self.state.decided,
                              k=self.state.k, killed=killed)

    # -- /getState (node.ts:197-199) -------------------------------------
    def get_state(self, node_id: int, trial: int = 0) -> dict:
        return observable_state(self.cfg, self.state, self.faults,
                                node_id, trial)

    def get_states(self, trial: int = 0) -> List[dict]:
        """Every node's /getState: one device-to-host copy per array, then
        N dict builds."""
        x = self.state.x[trial].tolist()
        decided = self.state.decided[trial].tolist()
        k = self.state.k[trial].tolist()
        killed = self.state.killed[trial].tolist()
        birth_faulty = (self.faults.faulty[trial].tolist()
                        if self.cfg.fault_model == "crash"
                        else [False] * self.cfg.n_nodes)
        out = []
        for i in range(self.cfg.n_nodes):
            if birth_faulty[i]:
                out.append({"killed": True, "x": None, "decided": None,
                            "k": None})
            else:
                out.append({"killed": killed[i],
                            "x": "?" if x[i] == VALQ else x[i],
                            "decided": decided[i], "k": k[i]})
        return out

    # -- flight recorder (cfg.record) -------------------------------------
    def get_round_history(self,
                          since_round: Optional[int] = None) -> List[dict]:
        """The recorder's rows, one dict a written round (state.REC_COLUMNS
        keys and "round"; utils.metrics.round_history_rows): empty before
        start(), growing between slices under poll_rounds.  ``since_round``
        is a cursor: only rows of a strictly greater round are returned.
        Needs SimConfig(record=True)."""
        if not self.cfg.record:
            raise ValueError(
                "get_round_history() requires SimConfig(record=True): "
                "the flight recorder is off and no round history was "
                "captured (cfg.debug streams host callbacks instead, but "
                "demotes the fused-pallas regime — see README "
                "Observability)")
        from ..utils.metrics import round_history_rows
        if self._recorder is None:
            return []
        return round_history_rows(self._recorder, since_round=since_round)

    # -- witness trace (cfg.witness) ---------------------------------------
    def get_witness(self) -> List[dict]:
        """The witness rows, one dict a watched (round, trial, node)
        (state.WIT_COLUMNS keys and the global "round" / "trial" / "node"
        ids; audit.witness_rows): empty before start(), growing between
        slices under poll_rounds.  Needs SimConfig(witness_trials=...,
        witness_nodes=k)."""
        if not self.cfg.witness:
            raise ValueError(
                "get_witness() requires SimConfig(witness_trials=..., "
                "witness_nodes=k): the witness recorder is off and no "
                "per-node trace was captured (see README Observability)")
        from ..audit import witness_rows
        from ..state import witness_node_ids
        if self._witness is None:
            return []
        return witness_rows(self._witness, self.cfg.witness_trials,
                            witness_node_ids(self.cfg))

    def close(self) -> None:
        pass
