"""Express-style event-loop oracle (port of benor_tpu/backends/express.py:
41-273, line for line).

A pure-Python re-host of the reference's per-node Express servers
(src/nodes/node.ts), the semantic oracle the device simulator is held
against.  The Node.js event loop becomes an explicit FIFO message queue,
one valid serialization of the reference's fire-and-forget fetches, and
the reference's quirks (SURVEY.md §2.1) are kept on purpose:

  * per-round unbounded proposal/vote buffers that re-fire the tally on
    every arrival past N-F (node.ts:47-52, 84-88 — quirk 8),
  * the quorum counts raw messages, "?" included (quirk 4),
  * plurality-adopt before the coin (node.ts:106-112 — quirk 9),
  * broadcasts include self (quirk 6),
  * killed nodes drop messages silently (node.ts:45 — quirk 3),
  * decided nodes keep looping rounds; the only brake is the global-halt
    probe that kills everyone once all are decided (node.ts:119-145 —
    quirk 5 / sub-behavior 5e),
  * faulty nodes are crash-from-birth with all-null state (node.ts:21-26).

No HTTP, no threads, no device: a host program, deterministic given
(seed, scenario, oracle_order).  ``cfg.oracle_order`` picks 'fifo' (queue
order) or 'shuffle' (each step delivers a uniformly random pending
message, drawn from a delivery stream seeded ``(seed ^ 0x9E3779B9) &
0xFFFFFFFF`` so the coin stream is unaffected).  The C++ oracle
(backends/native_oracle.py) runs the same algorithm and RNG, so traces
are bit-equal across the two for either order, and equal to the JAX
package's oracle.
"""

from __future__ import annotations

import random
from collections import defaultdict, deque
from typing import List, Optional


class _ExpressNode:
    """One reference node: state + message handler (node.ts:8-212)."""

    def __init__(self, net: "ExpressNetwork", node_id: int, n: int, f: int,
                 initial_value, is_faulty: bool):
        self.net = net
        self.node_id = node_id
        self.n = n
        self.f = f
        self.is_faulty = is_faulty
        # node.ts:21-26
        self.killed = is_faulty
        self.x = None if is_faulty else initial_value
        self.decided = None if is_faulty else False
        self.k = None if is_faulty else 0
        # node.ts:29-30 — unbounded per-round buffers
        self.proposals = defaultdict(list)
        self.votes = defaultdict(list)

    # /status (node.ts:33-39)
    def status(self):
        return ("faulty", 500) if self.killed else ("live", 200)

    # /start (node.ts:167-188)
    def on_start(self) -> None:
        if not self.killed:
            self.k = 1
            self.net.broadcast(self.k, self.x, "proposal phase")

    # /stop (node.ts:191-194)
    def on_stop(self) -> None:
        self.killed = True

    # /message (node.ts:43-163)
    def on_message(self, k: int, x, message_type: str) -> None:
        if self.killed:
            return  # quirk 3: silent drop
        if message_type == "proposal phase":
            buf = self.proposals[k]
            buf.append(x)
            if len(buf) >= self.n - self.f:          # quirk 4/8: >=, incl "?"
                count0 = buf.count(0)
                count1 = buf.count(1)
                if count0 > count1:
                    nx = 0
                elif count1 > count0:
                    nx = 1
                else:
                    nx = "?"
                self.net.broadcast(k, nx, "voting phase")
        elif message_type == "voting phase":
            buf = self.votes[k]
            buf.append(x)
            if len(buf) >= self.n - self.f:
                count0 = buf.count(0)
                count1 = buf.count(1)
                if count0 > self.f:                  # node.ts:99-104
                    self.x = 0
                    self.decided = True
                elif count1 > self.f:
                    self.x = 1
                    self.decided = True
                else:
                    if count0 + count1 > 0 and count0 > count1:   # quirk 9
                        self.x = 0
                    elif count0 + count1 > 0 and count0 < count1:
                        self.x = 1
                    else:
                        self.x = 0 if self.net.rng.random() > 0.5 else 1
                # global-halt probe (node.ts:119-145, sub-behavior 5e)
                self.net.schedule_halt_probe()
                self.k = k + 1                       # node.ts:147 — even if decided
                self.net.broadcast(self.k, self.x, "proposal phase")

    # /getState (node.ts:197-199)
    def get_state(self) -> dict:
        return {"killed": self.killed, "x": self.x,
                "decided": self.decided, "k": self.k}


class ExpressNetwork:
    """The whole network + its event loop.

    ``start()`` drains the message queue until the global-halt probe kills
    the network (all healthy decided), the round cap is exceeded (livelock
    scenarios), or the safety step cap trips.
    """

    def __init__(self, cfg, initial_values, faulty_list,
                 step_cap: Optional[int] = None):
        n = cfg.n_nodes
        f = cfg.n_faulty
        if cfg.trials != 1:
            raise ValueError(
                "the express oracle simulates a single trial; use the 'tpu' "
                "backend for Monte-Carlo (trials > 1) runs")
        if len(initial_values) != len(faulty_list) or n != len(initial_values):
            raise ValueError("Arrays don't match")          # launchNodes.ts:10-11
        if sum(bool(b) for b in faulty_list) != f:
            raise ValueError("faultyList doesnt have F faulties")  # :12-13
        self.n = n
        self.f = f
        self.max_rounds = cfg.max_rounds
        self.rng = random.Random(cfg.seed)
        self.order = cfg.oracle_order
        if self.order == "shuffle":
            # Dedicated delivery stream (seed derivation shared with the C++
            # oracle) so scheduling draws never perturb the coin stream.
            self.delivery_rng = random.Random((cfg.seed ^ 0x9E3779B9)
                                              & 0xFFFFFFFF)
            self.queue: list = []   # swap-pop bag; order is random anyway
        else:
            self.queue = deque()
        self._halt_pending = False
        self._started = False
        # Worst-case message volume per round is O(N^2) broadcasts (quirk-8
        # refires); the cap exists only to catch runaways and raises rather
        # than silently truncating the oracle.
        self._step_cap = step_cap if step_cap is not None else \
            max(500_000, 20 * n * n * cfg.max_rounds)
        self.nodes = [
            _ExpressNode(self, i, n, f, initial_values[i], bool(faulty_list[i]))
            for i in range(n)
        ]

    # fire-and-forget fetch POST /message to all N nodes, self included
    # (node.ts:72-80, 149-157, 173-185)
    def broadcast(self, k: int, x, message_type: str) -> None:
        if k > self.max_rounds:
            return  # round cap: bounds the livelock configurations
        for i in range(self.n):
            self.queue.append((i, k, x, message_type))

    def schedule_halt_probe(self) -> None:
        # The reference probe fires getState x N then maybe stop x N
        # (node.ts:119-145); both ride the same event loop as messages.
        self._halt_pending = True

    def _run_halt_probe(self) -> None:
        self._halt_pending = False
        # reachedFinality semantics: only decided === false blocks
        # (tests/utils.ts:22-24; faulty nodes' null is final).
        if all(nd.decided is not False for nd in self.nodes):
            for nd in self.nodes:
                nd.on_stop()

    # -- parity API ------------------------------------------------------
    @staticmethod
    def _check_trial(trial: int) -> None:
        if trial != 0:
            raise IndexError("express oracle has a single trial (index 0)")

    def status(self, node_id: int, trial: int = 0):
        self._check_trial(trial)
        return self.nodes[node_id].status()

    def start(self) -> None:
        # startConsensus: sequential /start fan-out (consensus.ts:3-8).
        # Idempotent so repeated /start routes don't re-broadcast.
        if self._started:
            return
        self._started = True
        for nd in self.nodes:
            nd.on_start()
        self._drain()

    def stop(self) -> None:
        for nd in self.nodes:
            nd.on_stop()

    def stop_node(self, node_id: int) -> None:
        self.nodes[node_id].on_stop()

    def inject_message(self, node_id: int, k, x, message_type) -> bool:
        """External message injection — the reference's POST /message
        surface (node.ts:43-163) on the oracle's event loop.

        The message is enqueued for ``node_id`` (under 'shuffle' its
        delivery position is drawn from the seeded delivery stream like
        any other pending message, so injected runs stay deterministic).
        If the network has already started, the event loop re-drains so
        the injection — and any cascade it triggers — settles before
        returning; pre-start injections sit ahead of the start
        broadcasts, one valid serialization of the reference's
        fire-and-forget concurrency.

        Returns False iff the target is killed at injection time: the
        reference's 200 response sits INSIDE the ``!killed`` guard
        (node.ts:44-161), so a killed node observably never answers —
        callers mirror that on the wire.
        """
        if self.nodes[node_id].killed:
            return False
        self.queue.append((node_id, k, x, message_type))
        if self._started:
            self._drain()
        return True

    def get_state(self, node_id: int, trial: int = 0) -> dict:
        self._check_trial(trial)
        return self.nodes[node_id].get_state()

    def get_states(self, trial: int = 0) -> List[dict]:
        self._check_trial(trial)
        return [nd.get_state() for nd in self.nodes]

    def close(self) -> None:
        self.queue.clear()

    # -- the event loop --------------------------------------------------
    def _drain(self) -> None:
        steps = 0
        q = self.queue
        shuffle = self.order == "shuffle"
        while q:
            if steps >= self._step_cap:
                raise RuntimeError(
                    f"express oracle exceeded its step cap ({self._step_cap} "
                    f"deliveries) before settling — results would be "
                    f"truncated mid-protocol; raise step_cap or lower "
                    f"max_rounds/N")
            if shuffle:
                # uniformly random pending message via swap-pop (identical
                # algorithm + RNG consumption as the C++ oracle's drain)
                j = self.delivery_rng.randrange(len(q))
                q[j], q[-1] = q[-1], q[j]
                dest, k, x, mtype = q.pop()
            else:
                dest, k, x, mtype = q.popleft()
            self.nodes[dest].on_message(k, x, mtype)
            if self._halt_pending:
                self._run_halt_probe()
            steps += 1
