"""HTTP observation layer: the reference's control plane over real sockets
(port of benor_tpu/backends/http_api.py).

Serves the four routes of the reference node server (src/nodes/node.ts) on
``BASE_NODE_PORT + node_id`` (src/config.ts:1), one listener per simulated
node, over any of the port's networks (``TpuNetwork``, ``ExpressNetwork``,
``NativeExpressNetwork``):

    GET /status    200 "live" | 500 "faulty"              node.ts:33-39
    GET /start     200 {"message": "Algorithm started"}   node.ts:167-188
    GET /stop      200 "killed"                           node.ts:191-194
    GET /getState  200 NodeState JSON                     node.ts:197-199

plus one route with no reference counterpart:

    GET /getRoundHistory?since_round=N   200 {"rows": [...], "cursor": r}
        — the flight recorder's cursor-based incremental feed
        (SimConfig(record=True); grows live under poll_rounds)

Semantics:
  * The first /start on any node runs the network to termination, so by
    default pollers observe the final snapshot, the fixed point the
    reference's pollers converge to.  With ``SimConfig(poll_rounds=c)``
    the loop runs in c-round slices and the snapshot is republished
    between slices: /getState (served on its own thread) then observes a
    live undecided network with growing k (benorconsensus.test.ts:149-160).
  * /stop kills only the receiving node (``stop_all`` stops them all).
  * POST /message (node.ts:43-163) is served when the network is an
    event-loop oracle: the forged message joins the seeded drain queue, so
    injected runs stay deterministic, and a killed target sends no response
    at all — the reference's 200 sits inside its ``!killed`` guard
    (node.ts:44-161).  On the device simulator it answers 405: peer
    messages are tensor data movement under the seeded scheduler, and an
    external injection would bypass it.

Wire-level interop (curl, the reference's test utilities pointed at
localhost) at demo-scale N; in-process code should use the facade
(api.py), which serves the same dicts without sockets.  The answers are
the JAX package's byte for byte.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..config import BASE_NODE_PORT


class _Handler(BaseHTTPRequestHandler):
    network = None          # set per listener class
    node_id: int = -1
    start_lock: Optional[threading.Lock] = None

    def log_message(self, fmt, *args):  # silence default stderr chatter
        pass

    def _send(self, code: int, body, as_json: bool,
              extra_headers=()) -> None:
        data = (json.dumps(body) if as_json else str(body)).encode()
        self.send_response(code)
        self.send_header(
            "Content-Type",
            "application/json" if as_json else "text/plain; charset=utf-8")
        for name, value in extra_headers:
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        from urllib.parse import parse_qs, urlsplit
        net, nid = self.network, self.node_id
        route = urlsplit(self.path)
        if route.path == "/status":
            body, code = net.status(nid)
            self._send(code, body, as_json=False)
        elif route.path == "/start":
            with self.start_lock:          # idempotent network-level start
                net.start()
            self._send(200, {"message": "Algorithm started"}, as_json=True)
        elif route.path == "/stop":
            net.stop_node(nid)
            self._send(200, "killed", as_json=False)
        elif route.path == "/getState":
            self._send(200, net.get_state(nid), as_json=True)
        elif route.path == "/getRoundHistory":
            self._get_round_history(parse_qs(route.query))
        else:
            self._send(404, {"error": f"no route {self.path}"}, as_json=True)

    def _get_round_history(self, query) -> None:
        """GET /getRoundHistory[?since_round=N] — the flight recorder's
        cursor-based incremental feed (meshscope's live progress plane;
        not a reference route, so it sits OUTSIDE the four parity routes
        above).  ``since_round`` is the last round the poller has seen:
        only strictly newer rows return, each carrying its true round
        index, plus ``cursor`` = the highest round in this response (or
        the request's cursor when nothing new) to pass back next poll.
        Under SimConfig(poll_rounds=c) the history grows between slices,
        so a polling client streams the run round by round without
        re-downloading the whole buffer.  405 on backends without a
        flight recorder (the event-loop oracles), 400 when the recorder
        is off (SimConfig(record=False)) or the cursor is malformed.
        """
        net = self.network
        if not hasattr(net, "get_round_history"):
            self._send(405, {
                "error": "round history not supported on this backend",
                "detail": "the flight recorder fills inside the tpu "
                          "backend's compiled loop; the event-loop "
                          "oracles have no device buffer to serve "
                          "(see README Observability)",
            }, as_json=True, extra_headers=(("Allow", "GET"),))
            return
        since = None
        raw = query.get("since_round")
        if raw:
            try:
                since = int(raw[0])
            except (TypeError, ValueError):
                self._send(400, {"error": "since_round must be an "
                                          "integer round index"},
                           as_json=True)
                return
        try:
            rows = net.get_round_history(since_round=since)
        except ValueError as e:        # recorder off (record=False)
            self._send(400, {"error": str(e)}, as_json=True)
            return
        cursor = rows[-1]["round"] if rows else (since if since is not None
                                                 else -1)
        self._send(200, {"rows": rows, "cursor": cursor}, as_json=True)

    #: Per-request drain budget in bytes (``NodeHttpCluster(drain_cap=...)``
    #: overrides it cluster-wide): how much of an unknowable-length body
    #: (chunked / malformed Content-Length) a handler will read before
    #: replying and closing.  1 MiB default — enough that any real
    #: client's in-flight bytes drain (avoiding the reply-discarding TCP
    #: RST), small enough that a hostile endless body cannot hold a
    #: handler thread.
    drain_cap: int = 1 << 20

    def _drain_best_effort(self, cap: Optional[int] = None) -> None:
        """Read whatever body bytes are ALREADY in flight before responding:
        replying and closing with unread data pending turns the close into a
        TCP RST that can discard the in-flight response.  Used when the body
        length is unknowable (chunked / malformed Content-Length).  Each
        read is gated on select() readability so a client that has finished
        sending and is awaiting the reply costs at most one 50 ms wait —
        not a blocking read that stalls until timeout.  ``cap`` defaults to
        the class's ``drain_cap`` (a NodeHttpCluster constructor knob)."""
        import select
        if cap is None:
            cap = self.drain_cap
        try:
            drained = 0
            while drained < cap:
                ready, _, _ = select.select([self.connection], [], [], 0.05)
                if not ready:
                    break
                chunk = self.rfile.read1(1 << 16)
                if not chunk:
                    break
                drained += len(chunk)
        except OSError:
            pass

    def do_POST(self):
        # A chunked body has no Content-Length and cannot be drained by
        # byte count — best-effort drain, then reject (RFC 9112 allows 411)
        # and close the connection.
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            self.close_connection = True
            self._drain_best_effort()
            self._send(411, {"error": "chunked bodies not supported"},
                       as_json=True)
            return
        # A malformed Content-Length must not crash the handler (no response
        # at all) or dispatch the route with the body unread: drain what we
        # can, answer 400, close.
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            self.close_connection = True
            self._drain_best_effort()
            self._send(400, {"error": "malformed Content-Length"},
                       as_json=True)
            return
        # Read the declared body before replying (same RST consideration).
        # Only /message consumes it, and a valid message is tens of bytes:
        # everything else (and anything past the 1 MiB cap) is drained and
        # discarded so a huge Content-Length cannot balloon memory.
        keep = self.path == "/message"
        cap = 1 << 20
        chunks = []
        kept = 0
        while length > 0:
            chunk = self.rfile.read(min(length, 1 << 16))
            if not chunk:
                break
            if keep and kept < cap:
                chunks.append(chunk)
                kept += len(chunk)
            length -= len(chunk)
        if not keep:
            self._send(404, {"error": f"no route {self.path}"}, as_json=True)
        elif kept >= cap:
            self._send(413, {"error": "body too large"}, as_json=True)
        else:
            self._post_message(b"".join(chunks))

    def _post_message(self, body: bytes) -> None:
        """POST /message — the reference's peer-message route
        (node.ts:43-163), served where injection is DETERMINISTIC.

        On an event-loop oracle backend (one exposing ``inject_message``)
        the forged message joins the seeded drain queue like any peer
        broadcast: 200 {"message": "Message received"} (node.ts:161), or —
        matching the reference, whose 200 sits inside the ``!killed``
        guard (node.ts:44-161) — NO response at all when the target is
        killed (the connection just closes).

        On the device simulator peer messages are tensor data movement
        under the seeded scheduler; accepting external injections would
        bypass it and break reproducibility, so it answers 405 pointing at
        the oracle backends (the JAX package's body, word for word).
        """
        net, nid = self.network, self.node_id
        if not hasattr(net, "inject_message"):
            # tpu backend only: messages are on-device data movement under
            # the seeded N9 scheduler — both oracles serve injection.
            self._send(405, {
                "error": "message injection not supported on this backend",
                "detail": "injection is served on the event-loop oracles "
                          "(backend='express' any time; backend='native' "
                          "pre-start), where the forged message joins the "
                          "seeded drain queue; this backend serves "
                          "/status /start /stop /getState "
                          "(see PARITY.md, 'Deliberate non-parities')",
            }, as_json=True, extra_headers=(("Allow", "GET"),))
            return
        try:
            msg = json.loads(body.decode("utf-8"))
            k, x, mtype = msg["k"], msg["x"], msg["messageType"]
        except (ValueError, KeyError, UnicodeDecodeError, TypeError):
            self._send(400, {"error": "body must be JSON with k, x, "
                                      "messageType (node.ts:44)"},
                       as_json=True)
            return
        # k keys the per-round buffers and mtype is string-compared: a
        # JSON-valid but wrong-typed value (k = [1]) would otherwise
        # poison the queue and blow up INSIDE the drain, wedging /start
        if not isinstance(k, int) or isinstance(k, bool) \
                or not isinstance(mtype, str):
            self._send(400, {"error": "k must be an integer and "
                                      "messageType a string"},
                       as_json=True)
            return
        # injections serialize with /start (and each other) exactly like
        # the reference's single-threaded event loop
        try:
            with self.start_lock:
                delivered = net.inject_message(nid, k, x, mtype)
        except ValueError as e:       # e.g. native's k-range contract
            self._send(400, {"error": str(e)}, as_json=True)
            return
        except NotImplementedError as e:   # native post-start injection
            self._send(405, {"error": str(e)}, as_json=True,
                       extra_headers=(("Allow", "GET"),))
            return
        except RuntimeError as e:
            # a post-start injection cascade can trip the oracle's step
            # cap (ExpressNetwork._drain); answer 500 so the wire can
            # tell it from the deliberate killed-target no-response
            self._send(500, {"error": str(e)}, as_json=True)
            return
        if delivered:
            self._send(200, {"message": "Message received"}, as_json=True)
        else:
            self.close_connection = True    # killed target: no response


class NodeHttpCluster:
    """N HTTP listeners (ports base..base+N-1) over one simulated network.

    Knobs:
      * ``drain_cap`` — per-request byte budget for draining an
        unknowable-length POST body before replying (the ``_Handler.
        drain_cap`` class attribute, see ``_drain_best_effort``);
        default 1 MiB.
      * ``addr_retries`` / ``addr_retry_delay_s`` — when a node's port
        ``base_port + node_id`` is taken (EADDRINUSE — a TIME_WAIT
        straggler from a previous cluster, or an unrelated process),
        binding is retried that many times with that delay, and a port
        that STAYS taken parks the node instead of crashing the whole
        cluster: the remaining N-1 listeners serve normally and the
        parked ids are recorded in ``self.parked`` (a parked node is
        observable via any sibling's /getState — the network itself is
        whole; only its per-node wire endpoint is missing).  A FULLY
        taken range still raises (zero listeners would silently hand
        clients some foreign process's ports), and any other OSError
        tears down cleanly and raises.
    """

    def __init__(self, network, base_port: int = BASE_NODE_PORT,
                 host: str = "127.0.0.1", drain_cap: int = 1 << 20,
                 addr_retries: int = 2,
                 addr_retry_delay_s: float = 0.05):
        import errno
        import time as _time

        self.network = network
        self.base_port = base_port
        self.servers: List[ThreadingHTTPServer] = []
        self.threads: List[threading.Thread] = []
        #: node ids whose port stayed EADDRINUSE after the retries —
        #: parked, not fatal (see class docstring).
        self.parked: List[int] = []
        start_lock = threading.Lock()
        n = network.cfg.n_nodes if hasattr(network, "cfg") else network.n
        try:
            for i in range(n):
                handler = type(f"_Handler{i}", (_Handler,), {
                    "network": network, "node_id": i,
                    "start_lock": start_lock, "drain_cap": drain_cap})
                srv = None
                for attempt in range(addr_retries + 1):
                    try:
                        srv = ThreadingHTTPServer((host, base_port + i),
                                                  handler)
                        break
                    except OSError as e:
                        if e.errno != errno.EADDRINUSE:
                            raise
                        if attempt < addr_retries:
                            _time.sleep(addr_retry_delay_s)
                if srv is None:
                    self.parked.append(i)
                    continue
                t = threading.Thread(target=srv.serve_forever, daemon=True)
                self.servers.append(srv)
                self.threads.append(t)
        except OSError:
            # non-EADDRINUSE failure on port base+k: release the
            # already-bound listeners before raising
            for srv in self.servers:
                srv.server_close()
            self.servers.clear()
            self.threads.clear()
            raise
        if n and not self.servers:
            # EVERY port taken: almost certainly another cluster (or a
            # whole foreign service) owns the range — a "cluster" with
            # zero listeners would let clients talk to that stranger's
            # ports and read valid-looking state from the WRONG network.
            # Parking exists to survive one straggler, not to serve
            # nothing; fail loudly instead.
            self.parked.clear()
            raise OSError(
                f"all {n} ports in [{base_port}, {base_port + n}) are "
                f"taken — another cluster on this base_port? (parking "
                f"covers individual EADDRINUSE stragglers, not a fully "
                f"occupied range)")

    def serve(self) -> "NodeHttpCluster":
        """Start the listener threads (idempotent: ``serve_network`` already
        serves, and entering the result as a context manager must not try to
        start the threads a second time)."""
        for t in self.threads:
            if t.ident is None:        # never started
                t.start()
        return self

    def stop_all(self) -> None:
        """consensus.ts:10-15 — /stop every node (state-level)."""
        self.network.stop()

    def close(self) -> None:
        """Stop every listener.  ``shutdown`` returns once its loop sees
        the request, at the loop's next poll (up to 0.5 s) or the next
        connection: the listeners are shut down side by side, each woken
        by an empty connection, so a cluster closes in milliseconds."""
        stoppers = [threading.Thread(target=srv.shutdown)
                    for srv in self.servers]
        for t in stoppers:
            t.start()
        for srv in self.servers:
            _wake(srv)
        for t in stoppers:
            t.join()
        for srv in self.servers:
            srv.server_close()

    def __enter__(self):
        return self.serve()

    def __exit__(self, *exc):
        self.close()


def _wake(srv) -> None:
    """Open and close one connection to a listener, so its loop wakes
    from its poll and sees a pending shutdown (the handler reads an empty
    request and answers nothing)."""
    try:
        socket.create_connection(srv.server_address[:2], timeout=1).close()
    except OSError:
        pass


def serve_network(network, base_port: int = BASE_NODE_PORT):
    """Convenience: wrap a launched network in a serving HTTP cluster."""
    return NodeHttpCluster(network, base_port).serve()
